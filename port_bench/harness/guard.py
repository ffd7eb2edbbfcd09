"""The JAX guard: the benchmark's process must hold no module of JAX, Flax or
the JAX package. Names are compared whole by their top-level part (the part
before the first dot): ``ctr_recommendation_tpu_torch`` is the port and is
not ``ctr_recommendation_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ctr_recommendation_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if top_level(n) in FORBIDDEN)
