"""Configuration: the port's own copy of ``OkTopkConfig``, ``scheduled_k``
and the ``TrainConfig`` fields the port reads.

Counterpart of ``oktopk_tpu/config.py`` (``OkTopkConfig`` :18-267,
``scheduled_k`` :270-286, ``TrainConfig`` :304-478; the BERT fields
:329-337). The port imports
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
from typing import Dict, Optional, Tuple

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
    """The ``TrainConfig`` fields the port reads, with the JAX defaults
    (the rest of the JAX surface is listed in ROADMAP.md)."""

    dnn: str = "vgg16"
    dataset: str = "cifar10"
    batch_size: int = 16
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = False
    max_epochs: int = 161
    nsteps_update: int = 1          # local microbatches per allreduce
    compressor: str = "oktopk"
    density: float = 0.02
    # the JAX command lines' --sigma-scale; no collective reads it
    sigma_scale: float = 2.5
    seed: int = 0
    num_workers: int = 1
    # global-norm clip of each worker's local gradient, before the
    # allreduce
    grad_clip: Optional[float] = None
    # fold momentum into the local gradient before compression; the SGD
    # update then runs momentum-free
    momentum_correction: bool = False
    # BertAdam's warmup fraction and schedule length (0: constant lr)
    warmup_proportion: float = 0.01
    total_steps: int = 0
    # the model's computation dtype (flax's ``dtype``): "bfloat16" runs
    # the products in bfloat16; master parameters, gradients, the sparse
    # collective and the optimizer stay float32
    compute_dtype: str = "float32"
    num_buckets: int = 1

    # ---- per-bucket algorithm/density autotuning (autotune/) ----------
    # calibrate -> trial -> policy before the first step (and again on
    # the re-tune cadence), each bucket's collective from the plan;
    # ``compressor`` is the fallback for buckets not planned yet
    autotune: bool = False
    # candidate registry names; sparse ones are crossed with
    # ``autotune_densities``, "dense" is the single density-1.0 point
    autotune_candidates: Tuple[str, ...] = ("dense", "oktopk")
    # density grid of the sparse candidates; () = just ``density``
    autotune_densities: Tuple[float, ...] = ()
    # timed steps per candidate per bucket in the trial phase
    autotune_trial_steps: int = 3
    # steps between re-tunes; 0 = tune once before the first step
    autotune_retune_every: int = 0
    # a challenger must beat the incumbent's fresh measurement by this
    # fraction to flip a bucket's plan (a flip re-plans the step)
    autotune_hysteresis: float = 0.15
    # trial only the top-N candidates by cost-model prior (0 = all)
    autotune_max_trials: int = 0
    # the decision journal's path; None keeps it in memory
    autotune_journal: Optional[str] = None

    # ---- the numeric-health guard and its escalation (resilience/) ----
    # the step's anomaly guard: nonfinite local gradients or
    # nonfinite/absurd reduced values trip a psum-agreed skip that rolls
    # back the optimizer, the BatchNorm statistics and every compressor
    # state; the Trainer runs the supervisor (strikes -> per-bucket dense
    # fallback -> restore from the last good checkpoint)
    resilience: bool = False
    # reduced-gradient magnitude that counts as an anomaly while finite
    resilience_abs_limit: float = 1e18
    # guard trips on a bucket before it falls back to dense
    resilience_strikes: int = 3
    # consecutive skipped steps before a restore
    resilience_divergence_limit: int = 8
    # steps between two escalations
    resilience_cooldown: int = 4
    # supervisor cadence in steps (each check reads the flags: a sync)
    resilience_check_every: int = 1
    # the health journal's path; None keeps it in memory
    resilience_journal: Optional[str] = None
    # the fault -> autotune feedback loop (resilience/feedback.py; needs
    # obs): a sustained stream of regression/guard_trip events (and, with
    # obs_quality, breached quality rollups) within the window forces a
    # re-calibrate and re-tune
    resilience_feedback: bool = False
    resilience_feedback_window: int = 32
    resilience_feedback_signals: int = 3
    resilience_feedback_cooldown: int = 64
    # guard-aware density backoff (resilience/density.py)
    resilience_density_backoff: bool = False
    resilience_near_ratio: float = 0.1
    resilience_backoff_steps: int = 3
    resilience_backoff_factor: float = 0.5
    resilience_backoff_max_level: int = 3
    resilience_clean_streak: int = 8

    # ---- the run journal (obs/) ---------------------------------------
    # an event bus and one JSONL run journal behind one environment
    # header: per-step metrics, phase timings, quality flushes and the
    # end-of-run volume reports (obs/journal.py)
    obs: bool = False
    # the journal's path; None keeps it in memory only
    obs_journal: Optional[str] = None
    # arm a bounded torch.profiler window on guard_trip, fallback and
    # breached quality_rollup events (obs/tracing.py AnomalyTracer)
    obs_trace_on_anomaly: bool = False
    # steps per anomaly-triggered trace window
    obs_trace_steps: int = 3
    # the anomaly traces' directory; None: "traces" beside the journal
    # (a temporary directory when the journal is in memory)
    obs_trace_dir: Optional[str] = None
    # at most this many anomaly windows a run (a flapping guard must not
    # fill the disk)
    obs_max_traces: int = 3
    # BENCH_r*.json key of the step-time regression baseline
    # (obs/regress.py); None: no regression checks
    obs_regress_key: Optional[str] = None
    # a step above tolerance x baseline journals a regression event
    obs_regress_tolerance: float = 1.5
    # per-phase limits in ms; a host-phase summary above its limit
    # journals a regression with key="phase:<name>"
    obs_phase_limits: Optional[Dict[str, float]] = None
    # the step's quality taps (obs/quality.py) into device-side rings,
    # drained every obs_quality_every steps (= the ring's capacity) into
    # quality events; obs/rollup.py rolls each up with breach detection
    obs_quality: bool = False
    obs_quality_every: int = 32
    # churn-signature bins (a power of two)
    obs_quality_sig_bins: int = 512
    # the rollup's breach limits: mean residual growth, realised density
    # over the target, mean churn and mean compression error
    obs_quality_growth_limit: float = 1.5
    obs_quality_collapse_ratio: float = 0.25
    obs_quality_churn_limit: float = 0.9
    obs_quality_comp_err_limit: float = 1.0

    def __post_init__(self):
        # the JAX command lines' choices for --compute-dtype
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}")

    def experiment_slug(self) -> str:
        mode = "comp" if self.compressor != "dense" else "dense"
        return (
            f"allreduce-{mode}-{self.compressor}-gwarmup-dc1-model-mgwfbp"
            f"-{self.dnn}-n{self.num_workers}-bs{self.batch_size}"
            f"-lr{self.lr:.4f}-ns{self.nsteps_update}-ds{self.density}"
        )
