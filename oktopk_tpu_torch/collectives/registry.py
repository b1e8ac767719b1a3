"""Algorithm registry.

Counterpart of ``oktopk_tpu/collectives/registry.py``: the same names and
aliases, and the same dense warmup in front of every sparse algorithm.
``hierarchical`` (a two-level composition over a pod mesh) is not ported
yet (ROADMAP.md, Queue 1 item 12) and raises ``NotImplementedError``.
"""

from __future__ import annotations

from oktopk_tpu_torch.collectives.dense import dense_allreduce, with_warmup
from oktopk_tpu_torch.collectives.gaussiank import gaussian_k
from oktopk_tpu_torch.collectives.gtopk import gtopk
from oktopk_tpu_torch.collectives.oktopk import oktopk
from oktopk_tpu_torch.collectives.topk_allgather import (
    topk_a,
    topk_a2,
    topk_a_opt,
)
from oktopk_tpu_torch.collectives.topk_sa import gaussian_k_sa, topk_sa

ALGORITHMS = {
    "dense": dense_allreduce,
    "topkA": topk_a,
    "topkA2": topk_a2,
    "topkAopt": topk_a_opt,
    "gtopk": gtopk,
    "gaussiank": gaussian_k,
    # the reference's packed-buffer wire layout; the same exchange here
    "gaussiankconcat": gaussian_k,
    "gaussiankSA": gaussian_k_sa,
    "topkSA": topk_sa,
    # script alias of the reference's job files
    "topkDSA": topk_sa,
    "oktopk": oktopk,
}
NOT_PORTED = ("hierarchical",)


def list_algorithms():
    """Sorted names ``get_algorithm`` accepts."""
    return sorted(ALGORITHMS)


def get_algorithm(name: str, warmup: bool = True):
    """Look up an algorithm; ``warmup=True`` puts the dense warmup in
    front of a sparse one."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"compressor {name!r} is not ported to oktopk_tpu_torch yet; "
            "see ROADMAP.md, Queue 1")
    try:
        fn = ALGORITHMS[name]
    except KeyError:
        raise ValueError(f"unknown compressor {name!r}; available: "
                         f"{list_algorithms()}") from None
    if warmup and name != "dense":
        fn = with_warmup(fn)
    return fn
