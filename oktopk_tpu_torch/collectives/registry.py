"""Algorithm registry.

Counterpart of ``oktopk_tpu/collectives/registry.py``: the same names and
aliases, and the same dense warmup in front of every sparse algorithm
but ``hierarchical``, whose warmup goes on its outer level.
"""

from __future__ import annotations

from oktopk_tpu_torch.collectives.dense import dense_allreduce, with_warmup
from oktopk_tpu_torch.collectives.gaussiank import gaussian_k
from oktopk_tpu_torch.collectives.gtopk import gtopk
from oktopk_tpu_torch.collectives.hierarchical import hierarchical
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
    # two-level composition: dense inside a pod, any of the above across
    # pods; takes a HierarchicalConfig and a two-level comm
    "hierarchical": hierarchical,
}


#: why a flat step (the Trainer's, the CLIs') refuses ``hierarchical``
TWO_LEVEL_ONLY = (
    "compressor 'hierarchical' needs a HierarchicalConfig and a two-level "
    "comm, and the Trainer's step is flat (one OkTopkConfig, one comm); the "
    "JAX Trainer cannot run it either. Build it with "
    "oktopk_tpu_torch.collectives.api.build_allreduce_step")


def list_algorithms():
    """Sorted names ``get_algorithm`` accepts."""
    return sorted(ALGORITHMS)


def get_algorithm(name: str, warmup: bool = True):
    """Look up an algorithm; ``warmup=True`` puts the dense warmup in
    front of a sparse one (``hierarchical`` composes it on its outer
    level, ``HierarchicalConfig.outer_warmup``)."""
    try:
        fn = ALGORITHMS[name]
    except KeyError:
        raise ValueError(f"unknown compressor {name!r}; available: "
                         f"{list_algorithms()}") from None
    if warmup and name not in ("dense", "hierarchical"):
        fn = with_warmup(fn)
    return fn
