"""Which modules a run may not have loaded: JAX and the JAX package.

Names are compared by their top-level part, the text before the first
dot, whole: `demonet_tpu_torch` is the program and allowed, though its
name begins with `demonet_tpu`, the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "demonet_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
