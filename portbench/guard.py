"""The import guard: what a run of the port's benchmark may not load.

Names are compared whole, by the part before the first dot:
``repro_torch`` (the port) is not ``repro`` (the JAX package).
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_modules(modules=None) -> set:
    """The forbidden top-level names among ``modules`` (the loaded
    ones by default)."""
    return top_level(sys.modules if modules is None else modules) & FORBIDDEN
