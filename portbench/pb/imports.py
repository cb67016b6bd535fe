"""The modules a run may not load: JAX and the JAX package.

Names are compared whole, by the part before the first dot, so the port
(``repro_torch``) is not taken for the JAX package (``repro``)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
