"""Family -> (init, apply, serving functions) dispatch."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, mamba2, transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    loss_fn: "Callable | None" = None  # LM training: ROADMAP P12
    apply: "Callable | None" = None
    init_cache: "Callable | None" = None
    prefill: "Callable | None" = None
    decode_step: "Callable | None" = None


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelApi(
            init=transformer.init,
            apply=transformer.apply,
            init_cache=transformer.init_cache,
            prefill=transformer.prefill,
            decode_step=transformer.decode_step,
        )
    if cfg.family in ("ssm", "hybrid"):
        mod = mamba2 if cfg.family == "ssm" else hybrid
        return ModelApi(
            init=mod.init,
            apply=mod.apply,
            init_cache=mod.init_cache,
            prefill=mod.prefill,
            decode_step=mod.decode_step,
        )
    if cfg.family == "audio":
        return ModelApi(
            init=encdec.init,
            apply=None,
            init_cache=encdec.init_cache,
            prefill=encdec.prefill,
            decode_step=encdec.decode_step,
        )
    raise ValueError(f"unknown family {cfg.family}")
