"""Host-level entry points: run a sparse allreduce over the comm.

Counterpart of ``oktopk_tpu/collectives/api.py:26-207``
(``batched_init_state``, ``build_allreduce_step``,
``build_quality_allreduce_step``, ``time_allreduce_step``,
``eps_vs_dense``). Where the JAX step is a jitted ``shard_map`` over a
device mesh, the port's step is the algorithm over a comm: by default
``StackedComm``, whose workers are the leading dimension of every tensor;
or ``ProcessGroupComm``, one worker per process (W = 1). The two-level
``hierarchical`` step runs over a two-level comm
(``comm.hierarchical_comm`` stacked, ``comm.hierarchical_process_comm``
across processes) with a ``HierarchicalConfig``.
"""

from __future__ import annotations

import time

import torch

from oktopk_tpu_torch.collectives.hierarchical import HierarchicalConfig
from oktopk_tpu_torch.collectives.registry import get_algorithm
from oktopk_tpu_torch.collectives.state import SparseState, init_state
from oktopk_tpu_torch.comm import StackedComm, hierarchical_comm
from oktopk_tpu_torch.obs.quality import commit, measure_bucket


def batched_init_state(cfg, device, dtype=torch.float32,
                       comm=None) -> SparseState:
    """Fresh state for the comm's W local workers (all
    ``cfg.num_workers`` without a comm), each row its own residual and
    thresholds. For a ``HierarchicalConfig`` it is the outer level's
    state, on every worker's row."""
    W = cfg.num_workers if comm is None else comm.local_workers
    base = cfg.outer_cfg if isinstance(cfg, HierarchicalConfig) else cfg
    return init_state(base, W, device, dtype)


def _setup(name: str, cfg, comm, warmup: bool):
    """(algorithm, config, comm) of a step, checked: a flat name with a
    flat config over a comm of ``cfg.num_workers``, or ``hierarchical``
    with a ``HierarchicalConfig`` over a two-level comm of its shape
    (``_hierarchical_setup`` in the JAX package)."""
    hier = isinstance(cfg, HierarchicalConfig)
    if hier and name != "hierarchical":
        raise ValueError(
            f"config is a HierarchicalConfig but algorithm is {name!r}; "
            "pass name='hierarchical' (outer algorithm goes in cfg.outer)")
    if name == "hierarchical" and not hier:
        raise TypeError(
            f"build step for {name!r} needs a HierarchicalConfig "
            "(collectives.hierarchical.make_hierarchical_config), got "
            f"{type(cfg).__name__}")
    if not hier:
        comm = StackedComm(cfg.num_workers) if comm is None else comm
        if comm.size != cfg.num_workers:
            raise ValueError(f"comm of {comm.size} workers for "
                             f"cfg.num_workers={cfg.num_workers}")
        return get_algorithm(name, warmup=warmup), cfg, comm
    if comm is None:
        comm = hierarchical_comm(cfg.num_pods, cfg.pod_size)
    for level, lvl, want in ((cfg.inter_axis, "inter", cfg.num_pods),
                             (cfg.intra_axis, "intra", cfg.pod_size)):
        have = getattr(getattr(comm, lvl, None), "size", None)
        if have != want:
            raise ValueError(
                f"comm level {level!r} ({lvl}) has size {have}, config "
                f"wants {want}")
    return (get_algorithm("hierarchical", warmup=False),
            cfg.replace(outer_warmup=warmup), comm)


def build_allreduce_step(name: str, cfg, comm=None, warmup: bool = True):
    """``step(grads [W, n], state) -> (results [W, n], state)``: every
    worker row of ``results`` holds the same reduced vector.

    ``cfg`` is an ``OkTopkConfig`` for the flat algorithms, or a
    ``HierarchicalConfig`` with ``name="hierarchical"``, whose comm is
    two-level (``hierarchical_comm(num_pods, pod_size)`` by default);
    ``warmup`` then goes on its outer level."""
    algo, cfg, comm = _setup(name, cfg, comm, warmup)

    def step(grads: torch.Tensor, state: SparseState):
        return algo(grads, state, cfg, comm)

    return step


def build_quality_allreduce_step(name: str, cfg, comm=None, quality=None,
                                 warmup: bool = True):
    """``build_allreduce_step`` plus the signal-fidelity tap:
    ``step(grads [W, n], state, qbuf) -> (results, state, qbuf)``, where
    ``qbuf`` is an ``obs.metrics_buffer.QualityBuffer`` of the comm's W
    rows (``quality``, an ``obs.quality.QualityConfig``, lives in its
    shapes and is not read). The dense reference the tap scores against
    is ``pmean(grad + residual)``; for ``hierarchical`` the pod mean
    stands in for the gradient (the intra pmean is lossless), as in the
    JAX package."""
    del quality
    algo, cfg, comm = _setup(name, cfg, comm, warmup)
    hier = isinstance(cfg, HierarchicalConfig)

    def step(grads: torch.Tensor, state: SparseState, qbuf):
        out, s2 = algo(grads, state, cfg, comm)
        if hier:
            dense = comm.spread(comm.inter.pmean(comm.leaders(
                comm.pod_mean(grads) + state.residual)))
        else:
            dense = comm.pmean(grads + state.residual)
        scalars = measure_bucket(out, dense, s2, qbuf.prev_sig,
                                 qbuf.prev_res_norm)
        return out, s2, commit(qbuf, s2.step, scalars, False)

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
