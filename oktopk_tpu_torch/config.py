"""Configuration: the port's own copy of ``OkTopkConfig``, ``scheduled_k``
and the ``TrainConfig`` fields the VGG-16 slice reads.

Counterpart of ``oktopk_tpu/config.py`` (``OkTopkConfig`` :18-267,
``scheduled_k`` :270-286, ``TrainConfig`` :304-478). The port imports
nothing of ``oktopk_tpu``, so the fields are copied here; the parity tests
hold both copies to the same defaults.

One reading differs from the JAX package: the port always follows the
JAX ``use_pallas=True`` selection contract (thresholds clamped to the
smallest normal f32, ops/compaction.py there), on the card through the
hand-written kernels and on the CPU through their plain versions. The
``use_pallas`` field is kept so configs round-trip, and is not read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class OkTopkConfig:
    """Static configuration of the sparse allreduce (field notes in
    ``oktopk_tpu/config.py``; every default is the same)."""

    n: int = 0
    num_workers: int = 1
    density: float = 0.02
    density_schedule: Optional[Tuple[Tuple[int, float], ...]] = None

    local_recompute_every: int = 32
    global_recompute_every: int = 32
    repartition_every: int = 64
    warmup_steps: int = 512

    local_adapt_scale: float = 1.012
    global_adapt_scale: float = 1.008

    probe_ratio: float = 1.25
    newton_exp_lo: float = 0.03
    newton_exp_hi: float = 0.5
    adapt_max_step: float = 1.5
    drift_clip_lo: float = 0.5
    drift_clip_hi: float = 2.0
    drift_ema: float = 1.0

    band_lo: float = 2.0 / 3.0
    band_hi: float = 5.0 / 4.0
    band_hi_global: float = 1.0
    local_k_target: float = 0.9
    global_k_target: float = 0.85

    cap_pair_factor: float = 2.0
    cap_gather_factor: float = 2.5
    cap_exact_factor: float = 4.0

    gaussian_refine_iters: int = 16
    sigma_scale: float = 2.5

    threshold_method: str = "bisect"
    bisect_iters: int = 30

    sa_dense_fallback_ratio: float = 2.0 / 3.0

    use_pallas: Optional[bool] = None
    # False = the unfused rung (separate residual add / mask / count /
    # pack passes); None or True = the fused front-end kernel.
    fuse_select: Optional[bool] = None
    bucket_index: int = 0
    wire_dtype: str = "bfloat16"

    @property
    def k(self) -> int:
        return max(1, int(self.density * self.n))

    @property
    def k_region(self) -> int:
        return max(1, self.k // max(1, self.num_workers))

    @property
    def cap_pair(self) -> int:
        cap = int(self.cap_pair_factor * self.k / max(1, self.num_workers)) + 8
        return min(self.n, cap)

    @property
    def cap_gather(self) -> int:
        cap = int(self.cap_gather_factor * self.k / max(1, self.num_workers)) + 8
        return min(self.n, cap)

    @property
    def cap_exact(self) -> int:
        cap = int(self.cap_exact_factor * self.k / max(1, self.num_workers)) + 8
        return min(self.n, cap)

    @property
    def cap_local(self) -> int:
        return min(self.n, int(self.cap_gather_factor * self.k) + 8)

    def __post_init__(self):
        if self.wire_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"wire_dtype must be 'float32' or 'bfloat16', "
                f"got {self.wire_dtype!r}")
        if self.density_schedule:
            starts = [s for s, _ in self.density_schedule]
            if starts != sorted(starts):
                raise ValueError(
                    f"density_schedule starts must be ascending: {starts}")
            if starts[0] != 0:
                raise ValueError(
                    f"density_schedule must start at step 0 (got "
                    f"{starts[0]}): every step needs an active pair — "
                    "add an explicit (0, density) entry for the early "
                    "phase")
            worst = max(d for _, d in self.density_schedule)
            if worst > self.density:
                raise ValueError(
                    f"density_schedule peaks at {worst} > density "
                    f"{self.density}; capacities are sized by `density`, "
                    "set it to the schedule's max")
            if self.threshold_method not in ("bisect", "hist"):
                raise ValueError(
                    "density_schedule needs threshold_method='bisect' or "
                    "'hist' (a traced target k; lax.top_k wants it "
                    "static)")
        if self.threshold_method not in ("sort", "bisect", "hist"):
            raise ValueError(
                f"threshold_method must be 'sort', 'bisect' or 'hist', "
                f"got {self.threshold_method!r}")
        for name in ("local_k_target", "global_k_target"):
            f = getattr(self, name)
            if not (self.band_lo <= f <= 1.0):
                raise ValueError(
                    f"{name}={f} must lie in [band_lo={self.band_lo:.3f}"
                    ", 1.0]")

    @property
    def wire_value_bytes(self) -> int:
        return 2 if self.wire_dtype == "bfloat16" else 4

    @property
    def wire_pair_bytes(self) -> int:
        return 4 + self.wire_value_bytes

    def replace(self, **kw) -> "OkTopkConfig":
        return dataclasses.replace(self, **kw)


def scheduled_k(cfg: OkTopkConfig, step: int) -> int:
    """Target k at host step ``step`` under ``cfg.density_schedule`` (the
    last pair whose start is <= step), or ``cfg.k`` without one. The step
    is a host integer here, so k is a Python int on every path."""
    if not cfg.density_schedule:
        return cfg.k
    starts = [s for s, _ in cfg.density_schedule]
    ks = [max(1, int(d * cfg.n)) for _, d in cfg.density_schedule]
    i = max(sum(step >= s for s in starts) - 1, 0)
    return ks[i]


def target_k(cfg: OkTopkConfig, k: int, factor: float) -> int:
    """The controller setpoint ``factor * k`` (collectives/oktopk.py
    ``_target_k`` in the JAX package). With a density schedule the JAX
    step computes it in float32 from a traced k; that rounding is kept so
    the two agree on every k."""
    if k >= cfg.n:
        return k
    if cfg.density_schedule:
        prod = np.float32(factor) * np.float32(k)
        return max(1, int(np.round(prod)))
    return max(1, int(round(factor * k)))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The ``TrainConfig`` fields the VGG-16 slice reads (the rest of the
    JAX surface is listed in ROADMAP.md)."""

    dnn: str = "vgg16"
    dataset: str = "cifar10"
    batch_size: int = 16
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    max_epochs: int = 161
    compressor: str = "oktopk"
    density: float = 0.02
    seed: int = 0
    num_workers: int = 1
    num_buckets: int = 1

    def experiment_slug(self) -> str:
        mode = "comp" if self.compressor != "dense" else "dense"
        return (
            f"allreduce-{mode}-{self.compressor}-gwarmup-dc1-model-mgwfbp"
            f"-{self.dnn}-n{self.num_workers}-bs{self.batch_size}"
            f"-lr{self.lr:.4f}-ns1-ds{self.density}"
        )
