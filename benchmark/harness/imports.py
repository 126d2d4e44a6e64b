"""The check that nothing of JAX or of the JAX package is loaded.

Names are compared by their top-level part, the part before the first dot,
as a whole: ``htool_tpu_torch`` is the port and passes, ``htool_tpu`` and
``htool_tpu.ops`` are the JAX package and fail.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "htool_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names=None) -> list:
    """The loaded modules (or the given names) whose top level is forbidden."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in list(names) if top_level(n) in FORBIDDEN)
