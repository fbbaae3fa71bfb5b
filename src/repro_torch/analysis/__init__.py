"""simcheck for the port: an invariant lint and opt-in runtime sanitizers.

* ``python -m repro_torch.analysis.lint src tests`` — AST lint, rules
  R002-R005 (:mod:`repro_torch.analysis.lint`).  Pure stdlib; importing it
  never touches torch.
* ``SIMDC_SANITIZE=1`` — runtime sanitizers
  (:mod:`repro_torch.analysis.sanitizers`): CUDA sync debugging on the
  ``@hot_path`` functions, use-after-recycle poisoning, the worker
  segment-leak audit, virtual-clock monotonicity.

``hot_path`` lives in :mod:`repro_torch.analysis.sanitizers` and is
re-exported here lazily so the lint CLI stays torch-free.
"""
from __future__ import annotations

__all__ = ["hot_path", "sanitizers"]


def __getattr__(name):
    if name in ("hot_path", "sanitizers"):
        import importlib

        mod = importlib.import_module("repro_torch.analysis.sanitizers")
        return mod if name == "sanitizers" else mod.hot_path
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
