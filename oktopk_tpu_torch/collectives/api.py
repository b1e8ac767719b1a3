"""Host-level entry points: run a sparse allreduce over the comm.

Counterpart of ``oktopk_tpu/collectives/api.py:26-207``
(``batched_init_state``, ``build_allreduce_step``, ``time_allreduce_step``,
``eps_vs_dense``). Where the JAX step is a jitted ``shard_map`` over a
device mesh, the port's step is the algorithm over a comm: by default
``StackedComm``, whose workers are the leading dimension of every tensor;
or ``ProcessGroupComm``, one worker per process (W = 1). The
hierarchical and quality-tap variants are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import time

import torch

from oktopk_tpu_torch.collectives.registry import get_algorithm
from oktopk_tpu_torch.collectives.state import SparseState, init_state
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig


def batched_init_state(cfg: OkTopkConfig, device, dtype=torch.float32,
                       comm=None) -> SparseState:
    """Fresh state for the comm's W local workers (all
    ``cfg.num_workers`` without a comm), each row its own residual and
    thresholds."""
    W = cfg.num_workers if comm is None else comm.local_workers
    return init_state(cfg, W, device, dtype)


def build_allreduce_step(name: str, cfg: OkTopkConfig, comm=None,
                         warmup: bool = True):
    """``step(grads [W, n], state) -> (results [W, n], state)``: every
    worker row of ``results`` holds the same reduced vector."""
    comm = StackedComm(cfg.num_workers) if comm is None else comm
    if comm.size != cfg.num_workers:
        raise ValueError(f"comm of {comm.size} workers for "
                         f"cfg.num_workers={cfg.num_workers}")
    algo = get_algorithm(name, warmup=warmup)

    def step(grads: torch.Tensor, state: SparseState):
        return algo(grads, state, cfg, comm)

    return step


def time_allreduce_step(step_fn, grads, state, iters: int = 3,
                        warmup_iters: int = 1):
    """``(times_ms, state)``: host-clock times of ``iters`` calls after
    ``warmup_iters`` untimed ones, the card synchronised before and after
    each timed call (on the CPU, the call is synchronous)."""
    def sync():
        if grads.device.type == "cuda":
            torch.cuda.synchronize(grads.device)

    for _ in range(warmup_iters):
        _, state = step_fn(grads, state)
    times_ms = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        _, state = step_fn(grads, state)
        sync()
        times_ms.append((time.perf_counter() - t0) * 1e3)
    return times_ms, state


def eps_vs_dense(dense_result: torch.Tensor,
                 sparse_result: torch.Tensor) -> torch.Tensor:
    """EPS = ||dense - sparse||_2 / ||dense||_2 (the reference's
    PROFILING_NORM measure)."""
    num = torch.linalg.vector_norm(dense_result - sparse_result)
    return num / (torch.linalg.vector_norm(dense_result) + 1e-12)
