"""Two-level hierarchical sparse allreduce: dense inside a pod, any
registry algorithm across pods.

Counterpart of ``oktopk_tpu/collectives/hierarchical.py:56-210``:

    hierarchical(grad) = broadcast_intra(outer_algo(pmean_intra(grad)))

- intra level: a dense pmean over the pod, lossless, so every member of a
  pod holds the pod-mean gradient afterwards;
- inter level: ``cfg.outer`` ("dense", "oktopk", "topkA", ...) across the
  pods with ``cfg.outer_cfg`` (``num_workers == num_pods``); every
  ``SparseState`` field (residual, thresholds, wire accounting) lives
  here, the intra pmean has no error feedback to keep;
- broadcast: the comm's ``spread`` (``comm/stacked.py``: the pod leaders'
  results to every member's row; ``comm/process_group.py``: nothing to
  do, every rank ran the identical exchange).

The phase scopes (``obs/anatomy.py``) carry the level lanes of
JAX's (:180, :187): the pod mean is ``exchange`` on level 0, and the
outer algorithm runs inside a level-1 container (``anat/b000/lvl1``),
so its own phases land on level 1.

Wire bytes are kept per level (``wire_bytes_intra`` / ``_inter``), so
``obs/volume.py`` holds each level against its own budget.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from oktopk_tpu_torch.collectives.state import TENSOR_FIELDS, SparseState
from oktopk_tpu_torch.collectives.wire import dense_wire_bytes
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.obs.anatomy import phase_scope

# the JAX package's mesh axis names (comm/mesh.py there); here they name
# the levels in messages
POD_AXIS = "pod"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class HierarchicalConfig:
    """Static configuration of the two-level composition: the OUTER
    algorithm's config (``num_workers == num_pods``, the inter-level
    density) plus the topology. Build it with
    :func:`make_hierarchical_config`."""

    outer_cfg: OkTopkConfig
    num_pods: int = 1
    pod_size: int = 1
    inner: str = "dense"            # intra-level algorithm (dense only)
    outer: str = "oktopk"           # inter-level registry algorithm
    inter_axis: str = POD_AXIS      # the level across pods
    intra_axis: str = DATA_AXIS     # the level within a pod
    outer_warmup: bool = True       # dense warmup on the outer level
    # share of the end-to-end density budget granted to the inter level
    density_split: float = 1.0

    def __post_init__(self):
        if self.num_pods < 1 or self.pod_size < 1:
            raise ValueError("need num_pods >= 1 and pod_size >= 1, got "
                             f"{self.num_pods}x{self.pod_size}")
        if self.inner != "dense":
            raise ValueError(
                f"inner level supports only 'dense' (got {self.inner!r}); "
                "the intra-pod fabric is where dense is already optimal")
        if self.outer_cfg.num_workers != self.num_pods:
            raise ValueError(
                f"outer_cfg.num_workers ({self.outer_cfg.num_workers}) "
                f"must equal num_pods ({self.num_pods})")
        if self.inter_axis == self.intra_axis:
            raise ValueError("inter_axis and intra_axis must differ, got "
                             f"{self.inter_axis!r} twice")
        if not 0.0 < self.density_split <= 1.0:
            raise ValueError(
                f"density_split must be in (0, 1], got {self.density_split}")

    @property
    def n(self) -> int:
        return self.outer_cfg.n

    @property
    def num_workers(self) -> int:
        """Total world size across both levels."""
        return self.num_pods * self.pod_size

    @property
    def density(self) -> float:
        """End-to-end delivered density: the inter level's (the intra
        pmean is lossless)."""
        return self.outer_cfg.density

    def replace(self, **kw) -> "HierarchicalConfig":
        return dataclasses.replace(self, **kw)

    def level_plan(self):
        """The per-level (algorithm, density) plan."""
        return [
            {"level": "intra", "algo": self.inner, "density": 1.0},
            {"level": "inter", "algo": self.outer,
             "density": self.outer_cfg.density},
        ]


def make_hierarchical_config(cfg: OkTopkConfig, num_pods: int,
                             pod_size: Optional[int] = None, *,
                             inner: str = "dense", outer: str = "oktopk",
                             density_split: float = 1.0,
                             inter_axis: str = POD_AXIS,
                             intra_axis: str = DATA_AXIS,
                             ) -> HierarchicalConfig:
    """A :class:`HierarchicalConfig` from a FLAT config (``num_workers``
    the total, ``density`` the end-to-end budget): the outer config keeps
    every algorithm knob at ``num_workers=num_pods`` and ``density *
    density_split`` (a dense outer keeps density 1.0)."""
    if pod_size is None:
        if cfg.num_workers % num_pods:
            raise ValueError(f"num_workers ({cfg.num_workers}) not "
                             f"divisible by num_pods ({num_pods})")
        pod_size = cfg.num_workers // num_pods
    if num_pods * pod_size != cfg.num_workers:
        raise ValueError(
            f"num_pods*pod_size ({num_pods}x{pod_size}) must equal "
            f"cfg.num_workers ({cfg.num_workers})")
    outer_density = 1.0 if outer == "dense" else cfg.density * density_split
    outer_cfg = cfg.replace(num_workers=num_pods, density=outer_density)
    return HierarchicalConfig(outer_cfg=outer_cfg, num_pods=num_pods,
                              pod_size=pod_size, inner=inner, outer=outer,
                              inter_axis=inter_axis, intra_axis=intra_axis,
                              density_split=density_split)


def map_rows(state: SparseState, fn) -> SparseState:
    """``fn`` applied to every tensor field; the host step carried."""
    return state.replace(**{f: fn(getattr(state, f)) for f in TENSOR_FIELDS})


def hierarchical(grad: torch.Tensor, state: SparseState,
                 cfg: HierarchicalConfig, comm):
    """The two-level step over a two-level comm
    (``comm.stacked.hierarchical_comm`` or
    ``comm.process_group.hierarchical_process_comm``)."""
    from oktopk_tpu_torch.collectives.registry import get_algorithm
    ocfg = cfg.outer_cfg
    bkt = ocfg.bucket_index

    # level 0: the pod-mean gradient, identical on every pod member
    with phase_scope("exchange", bkt, level=0):
        g_pod = comm.pod_mean(grad)

    # level 1: the outer algorithm across pods, once per pod
    outer_fn = get_algorithm(cfg.outer, warmup=cfg.outer_warmup)
    with phase_scope(None, bkt, level=1):
        out, s2 = outer_fn(comm.leaders(g_pod),
                           map_rows(state, comm.leaders), ocfg, comm.inter)
    out, s2 = comm.spread(out), map_rows(s2, comm.spread)

    # per-level accounting: the outer algorithm's bump() counted the inter
    # bytes; fold the intra ring allreduce on top and split the ledgers
    pod = cfg.pod_size
    intra_vals = 2.0 * ocfg.n * (pod - 1) / max(1, pod)
    intra_wb = dense_wire_bytes(intra_vals)
    inter_wb = s2.last_wire_bytes
    s2 = s2.replace(
        volume_elems=s2.volume_elems + intra_vals,
        last_volume=s2.last_volume + intra_vals,
        wire_bytes=s2.wire_bytes + intra_wb,
        last_wire_bytes=s2.last_wire_bytes + intra_wb,
        wire_bytes_intra=state.wire_bytes_intra + intra_wb,
        last_wire_bytes_intra=torch.full_like(inter_wb, intra_wb),
        wire_bytes_inter=state.wire_bytes_inter + inter_wb,
        last_wire_bytes_inter=inter_wb,
    )
    return out, s2
