"""Family -> (init, loss_fn, apply, serving functions) dispatch.

``loss_fn`` trains every family: dense, MoE, VLM, SSM, hybrid, hybrid MoE
and audio.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (
    encdec,
    granite_hybrid,
    hybrid,
    mamba2,
    transformer,
)


@dataclasses.dataclass(frozen=True)
class ModelApi:
    init: Callable
    loss_fn: "Callable | None" = None
    apply: "Callable | None" = None
    init_cache: "Callable | None" = None
    prefill: "Callable | None" = None
    decode_step: "Callable | None" = None


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelApi(
            init=transformer.init,
            loss_fn=transformer.loss_fn,
            apply=transformer.apply,
            init_cache=transformer.init_cache,
            prefill=transformer.prefill,
            decode_step=transformer.decode_step,
        )
    if cfg.family in ("ssm", "hybrid", "hybrid_moe"):
        mod = {"ssm": mamba2, "hybrid": hybrid,
               "hybrid_moe": granite_hybrid}[cfg.family]
        return ModelApi(
            init=mod.init,
            loss_fn=mod.loss_fn,
            apply=mod.apply,
            init_cache=mod.init_cache,
            prefill=mod.prefill,
            decode_step=mod.decode_step,
        )
    if cfg.family == "audio":
        return ModelApi(
            init=encdec.init,
            loss_fn=encdec.loss_fn,
            apply=None,
            init_cache=encdec.init_cache,
            prefill=encdec.prefill,
            decode_step=encdec.decode_step,
        )
    raise ValueError(f"unknown family {cfg.family}")
