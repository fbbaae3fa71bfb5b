"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "phi3_medium_14b",
    "llama3_2_3b",
    "qwen2_7b",
    "nemotron_4_15b",
    "zamba2_1_2b",
    "mamba2_1_3b",
    "granite_moe_3b_a800m",
    "phi3_5_moe_42b_a6_6b",
    "internvl2_26b",
    "seamless_m4t_medium",
    "avazu_lr",  # the paper's own model (not an LM cell)
)

# The port's own architectures, with no twin in the JAX package (whose
# tests hold ARCH_IDS to it).
PORT_ARCH_IDS = (
    "granite_4_0_h_small",
)

# Dashed aliases matching the assignment sheet.
ALIASES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen2-7b": "qwen2_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mamba2-1.3b": "mamba2_1_3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def get_config(arch: str, *, smoke: bool = False):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def lm_arch_ids() -> tuple[str, ...]:
    return tuple(a for a in ARCH_IDS if a != "avazu_lr")
