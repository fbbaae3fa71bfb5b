"""The benchmark's one door into the program (``repro_torch``): its
configuration built and checked against the configuration file, the
weights' tree checked against the port's own layout, and the launch
counters the port keeps.  Only the drivers and the readers of counters
import the port, through here."""
from __future__ import annotations


def model_config(c: dict, fields: dict):
    """The port's ``ModelConfig`` of registry arch ``c["arch"]`` (its
    smoke-size twin when ``c["smoke"]``); raises where a field differs
    from the file's.  ``fields`` maps configuration-file keys to the
    port's fields (the architecture's ``FIELDS``)."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(c["arch"], smoke=bool(c.get("smoke", False)))
    want = {f: c[k] for k, f in fields.items()}
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
    """Every launch counter the port's kernel wrappers keep, by
    ``<wrapper>.<counter>`` (``ssd_scan.tc_launches``): each integer
    attribute named ``*launches`` of a function of a
    ``repro_torch.kernels.<kernel>.ops`` module."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels

    out = {}
    for pkg in pkgutil.iter_modules(kernels.__path__):
        if not pkg.ispkg:
            continue
        ops = importlib.import_module(f"{kernels.__name__}.{pkg.name}.ops")
        for name, fn in vars(ops).items():
            if not (callable(fn) and getattr(fn, "__module__", None)
                    == ops.__name__):
                continue
            for attr, v in vars(fn).items():
                if attr.endswith("launches") and type(v) is int:
                    out[f"{name}.{attr}"] = v
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
