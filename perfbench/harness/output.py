"""The result line: JSON with no non-finite number, and the look for JAX
or the JAX package in the process that prints it."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list:
    """Modules whose top-level name (the part before the first dot), taken
    whole, is JAX's or the JAX package's: ``repro_torch`` is not
    ``repro``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def finite(obj):
    """``obj`` with every non-finite float (a check that found nothing to
    compare, a request that never came) as null, so the line is JSON."""
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
