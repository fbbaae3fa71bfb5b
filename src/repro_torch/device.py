"""Device selection for every entry point of the port.

There is no silent fallback: ``"cuda"`` is the default, and asking for it on
a machine without a usable card raises instead of running on the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is available (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
