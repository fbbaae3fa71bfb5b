"""SimDC on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

The package mirrors ``repro``'s layout (``analysis``, ``core``, ``configs``,
``data``, ``models``, ``kernels``) and imports ``torch`` and numpy only.
Every entry point that creates tensors takes ``device=`` and defaults to
``"cuda"``; without a card the caller must ask for ``device="cpu"``
explicitly (:func:`repro_torch.device.resolve_device`).  The TPU kernels of
the ported paths are hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use: ``fed_reduce`` on the federated round,
``decode_attention`` and ``flash_attention`` on LM serving.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
