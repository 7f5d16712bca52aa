"""The import guard: the benchmark measures the PyTorch port alone.

The JAX package's name is a prefix of the port's (``fei_tpu`` and
``fei_tpu_torch``), so modules are compared by their whole top-level name,
the part before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fei_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
