"""The import guard: nothing a run loads may be JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) whole, so ``repro_torch`` passes and ``repro`` does not.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded module names whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(where: str) -> bool:
    """True when no forbidden module is loaded; otherwise names them on
    standard error and returns False."""
    found = forbidden_loaded()
    if found:
        print(f"import guard ({where}): forbidden modules loaded: "
              f"{', '.join(found[:20])}", file=sys.stderr)
    return not found
