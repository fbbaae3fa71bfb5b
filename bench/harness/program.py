"""The benchmark's one door into the program (``repro_torch``): its
configuration built and checked against the configuration file, the
weights' tree checked against the port's own layout, and the launch
counters the port keeps.  Only the drivers and the readers of counters
import the port, through here."""
from __future__ import annotations

# configuration-file key -> the port's ModelConfig field
_FIELDS = {
    "d_model": "d_model", "num_hidden_layers": "num_layers",
    "vocab_size": "vocab_size", "expand": "ssm_expand",
    "headdim": "ssm_head_dim", "d_state": "ssm_state",
    "ngroups": "ssm_groups", "d_conv": "ssm_conv_width",
    "chunk_size": "ssm_chunk", "rms_norm_eps": "norm_eps",
    "tie_embeddings": "tie_embeddings", "dtype": "dtype",
}
def model_config(c: dict):
    """The port's ``ModelConfig`` of registry arch ``c["arch"]`` (its
    smoke-size twin when ``c["smoke"]``); raises where a width differs
    from the file's."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(c["arch"], smoke=bool(c.get("smoke", False)))
    want = {f: c[k] for k, f in _FIELDS.items()}
    bad = {f: (getattr(cfg, f), v) for f, v in want.items()
           if getattr(cfg, f) != v}
    if cfg.family != c["family"] or bad:
        raise ValueError(f"{c['name']}: the port's {c['arch']} differs from "
                         f"the configuration file (port, file): {bad}")
    return cfg


def check_tree(tree, cfg) -> None:
    """Raises unless ``tree`` has the paths, shapes and dtypes of the
    port's own params for ``cfg`` (made on the meta device)."""
    from repro_torch.models.registry import get_model

    want = get_model(cfg).init(0, cfg, device="meta")

    def walk(a, b, path):
        if isinstance(b, dict):
            if not isinstance(a, dict) or set(a) != set(b):
                raise ValueError(f"weights tree at {path}: keys "
                                 f"{sorted(a) if isinstance(a, dict) else a} "
                                 f"!= the port's {sorted(b)}")
            for k in b:
                walk(a[k], b[k], path + (k,))
        elif isinstance(b, list):
            if not isinstance(a, list) or len(a) != len(b):
                raise ValueError(f"weights tree at {path}: not a list of "
                                 f"{len(b)}")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        elif tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(f"weights tree at {path}: {tuple(a.shape)} "
                             f"{a.dtype} != the port's {tuple(b.shape)} "
                             f"{b.dtype}")

    walk(tree, want, ())


def counters() -> dict:
    """The port's launch counters of its hand-written kernels."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"ssd_scan": ssd_scan.launches,
            "ssd_scan_tc": ssd_scan.tc_launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches,
            "ssd_scan_bwd_tc": ssd_scan.tc_bwd_launches}


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
