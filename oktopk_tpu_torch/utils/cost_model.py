"""Analytic alpha-beta communication cost models.

Counterpart of ``oktopk_tpu/utils/cost_model.py`` (``topk_cost`` :20,
``allgather_cost`` :25, ``allreduce_cost`` :31, ``sparse_allreduce_cost``
:37), copied. Reference: ``VGG/utils.py:86-134``, the latency/bandwidth
(alpha-beta) models for topk, allgather and allreduce used to reason
about density selection. The autotuner's cost-model prior
(``autotune/policy.py::predict_ms``) prices its candidates with them.
"""

from __future__ import annotations

# The reference's MPI defaults and the JAX package's ICI ones (~2 orders
# faster). Both kept so ablations can model either fabric; neither is a
# measurement of any link the port runs on.
MPI_ALPHA = 5e-6        # per-message latency, seconds
MPI_BETA = 1e-9         # per-element time (≈1 GB/s/element-ish, f32)
ICI_ALPHA = 1e-6
ICI_BETA = 1e-11


def topk_cost(n: int, gamma: float = 1e-9) -> float:
    """Local top-k selection cost ~ gamma * n (sort-free threshold count)."""
    return gamma * n


def allgather_cost(k: int, p: int, alpha: float = ICI_ALPHA,
                   beta: float = ICI_BETA) -> float:
    """Ring allgather of k elements from each of p workers."""
    return (p - 1) * alpha + (p - 1) * k * beta


def allreduce_cost(n: int, p: int, alpha: float = ICI_ALPHA,
                   beta: float = ICI_BETA) -> float:
    """Ring allreduce: reduce-scatter + allgather, ~2n(p-1)/p elements."""
    return 2 * (p - 1) * alpha + 2.0 * n * (p - 1) / p * beta


def sparse_allreduce_cost(k: int, p: int, alpha: float = ICI_ALPHA,
                          beta: float = ICI_BETA) -> float:
    """Ok-Topk two-phase cost: O(1) latency rounds, <6k elements
    (paper property; reference README.md:2)."""
    # all_to_all of ~2k scalars each way
    phase_a = alpha + 4.0 * k * beta
    phase_b = (p - 1) * alpha + 2.0 * k * beta
    return phase_a + phase_b
