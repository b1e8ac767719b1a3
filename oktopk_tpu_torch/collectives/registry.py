"""Algorithm registry: the collectives this port has so far.

Counterpart of ``oktopk_tpu/collectives/registry.py``. The other names of
the JAX registry are not ported yet (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

from oktopk_tpu_torch.collectives.dense import dense_allreduce, with_warmup
from oktopk_tpu_torch.collectives.oktopk import oktopk

ALGORITHMS = {
    "dense": dense_allreduce,
    "oktopk": oktopk,
}


def list_algorithms():
    return sorted(ALGORITHMS)


def get_algorithm(name: str, warmup: bool = True):
    """Look up an algorithm; ``warmup=True`` puts the dense warmup in
    front of a sparse one."""
    try:
        fn = ALGORITHMS[name]
    except KeyError:
        raise NotImplementedError(
            f"compressor {name!r} is not ported to oktopk_tpu_torch yet "
            f"(ported: {list_algorithms()}); see ROADMAP.md for the "
            "remaining collectives") from None
    if warmup and name != "dense":
        fn = with_warmup(fn)
    return fn
