"""The modules a run may not hold: JAX and the JAX package. Names compare
whole, by the part before the first dot, so ``collide2d_tpu_torch`` is not
``collide2d_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "collide2d_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
