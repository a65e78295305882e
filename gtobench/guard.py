"""The check that a run loaded nothing of JAX or the JAX package.

The port's package name, `grasptrajopt_tpu_torch`, begins with the JAX
package's name, `grasptrajopt_tpu`, so modules are compared by their whole
top-level name (the part before the first dot), never by a prefix.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "grasptrajopt_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (of `sys.modules` by default) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
