"""SimDC on PyTorch and CUDA: the port of :mod:`repro` to one NVIDIA H100.

The package mirrors ``repro``'s layout (``analysis``, ``checkpoint``,
``core``, ``configs``, ``data``, ``examples``, ``models``, ``kernels``,
``optim``) and imports ``torch`` and numpy only.
Every entry point that creates tensors takes ``device=`` and defaults to
``"cuda"``; without a card the caller must ask for ``device="cpu"``
explicitly (:func:`repro_torch.device.resolve_device`).  The TPU kernels of
the ported paths are hand-written CUDA kernels under ``csrc/``, built with
``nvcc`` at first use: ``fed_reduce`` on the federated round,
``decode_attention`` and ``flash_attention`` on LM serving, ``ssd_scan``
on the Mamba2 and hybrid models.

``resolve_device`` is re-exported lazily, so that importing the package
(for the stdlib-only lint CLI, ``python -m repro_torch.analysis.lint``)
does not import torch.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from repro_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
