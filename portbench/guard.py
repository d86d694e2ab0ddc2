"""What a run must not have loaded: JAX, its libraries and the JAX
package, compared by whole top-level module name (the port's own name,
``needletail_tpu_torch``, begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_in"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "needletail_tpu"})


def forbidden_in(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among module ``names`` (default: every
    module this process has loaded)."""
    if names is None:
        names = list(sys.modules)
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
