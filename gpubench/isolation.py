"""The modules the benchmark's process may not hold: JAX, its libraries
and the JAX package. Names are compared by their top-level part (before
the first dot), whole, so that ``oktopk_tpu_torch`` is not
``oktopk_tpu``."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "oktopk_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module ``names``."""
    return sorted({top_level(n) for n in names} & FORBIDDEN)
