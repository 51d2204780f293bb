"""The import guard: a benchmark run of the port may load neither JAX nor
the JAX package. Module names are compared by their top-level name, whole:
exsaddle_tpu_torch begins with exsaddle_tpu and is not a hit."""

import sys

BANNED = ("jax", "jaxlib", "flax", "exsaddle_tpu")


def banned_loaded(modules=None):
    """Sorted top-level names in `modules` (default sys.modules) that are
    banned."""
    names = sys.modules if modules is None else modules
    return sorted({str(n).split(".")[0] for n in list(names)}
                  & set(BANNED))
