from repro_torch.kernels.ssd_scan.ops import (
    ssd_decode_step,
    ssd_ref,
    ssd_scan,
)

__all__ = ["ssd_scan", "ssd_decode_step", "ssd_ref"]
