"""The check that the run loaded neither JAX nor the JAX package: the
top-level name of each module (the part before the first dot), compared
whole, so the port (`p265_tpu_torch`) passes and `p265_tpu` fails."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "p265_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: every
    module loaded in this process)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
