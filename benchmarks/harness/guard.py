"""The import guard: no module of the JAX side may be loaded in a run."""

from __future__ import annotations

import sys

#: top-level module names a run may not hold, compared whole: cmtci_torch passes
FORBIDDEN = ("jax", "jaxlib", "flax", "cmtci")


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names in `modules` (sys.modules by default) that are
    forbidden, each compared whole with the part before the first dot."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
