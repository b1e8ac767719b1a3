"""A minimal data-parallel trainer: P workers stacked on one device, or
one worker per process.

Counterpart of the parts of ``oktopk_tpu/train/trainer.py`` and
``optim/distributed.py::build_sparse_grad_step`` that the port runs
(init, ``train_step``, ``train`` with ``should_stop`` and ``last_step``
(:635-671), ``eval_step`` (:874-919), the step options
``nsteps_update``, ``grad_clip``, momentum correction and
``profile_norm``, the workload dispatch of :44-53, :98-107, :558-624
for the CNN zoo, BERT pretraining, the PTB LSTM and DeepSpeech on AN4,
the run journal with its quality taps and anomaly tracer, the step's
anatomy scopes, the resilience surface and the autotuner with its fault
feedback loop, each below).

With ``cfg.obs`` the Trainer runs the JAX Trainer's run journal
(:121-170): an ``EventBus`` and a
``RunJournal`` (``cfg.obs_journal``, in memory when None), then, with
``cfg.obs_quality``, the step's quality taps (``SparseGradStep``'s
rings) and a ``RollupEngine`` built after the journal, so each
``quality_rollup`` lands directly after its ``quality`` event; with
``cfg.obs_regress_key`` a ``RegressionDetector``; with
``cfg.obs_trace_on_anomaly`` an ``obs.tracing.AnomalyTracer`` on the bus
(:152-163: its directory ``cfg.obs_trace_dir``, else ``traces`` beside
the journal, else a temporary directory), stepped before each step and
closed at the end of ``train`` (:678-682, :746-747). ``train`` journals a
``step`` event per step on the log cadence from a pending list (one
device-to-host copy a flush, no per-step sync), a ``phase`` event from
its ``PhaseTimers``, the quality flush every ``cfg.obs_quality_every``
steps (``_flush_quality``: one copy of the rings to the host), and at
the end the tail flush and one ``volume_report`` per bucket.

The step opens JAX's phase scopes (``obs/anatomy.py``): ``fwd_bwd``
around every worker's forward and backward, the flat copy and the clip
(JAX's :273, which scopes the gradient and the clip), the bucket
containers in ``SparseGradStep``, and ``optimizer`` around the update
(:401). They are host-side ranges, opened only while a profiler runs;
the step is bit-identical with them on and off. Each backward goes
through ``anatomy.backward_scope``, so that on the card the kernels
autograd launches from its device thread land in an ``anat/fwd_bwd``
range too. While a span recorder is on (``anatomy.record_spans``), the
whole ``train_step`` is the root ``step`` span, with these scopes'
spans under it.

The train state goes in and out as the JAX package's ``DistTrainState``
state dict (``train_state`` / ``load_train_state``, over
``convert.train_state_to_jax`` / ``load_train_state_from_jax``), which
``train/checkpoint.py`` writes in the JAX package's file format. Across
processes the export gathers every rank's rows of the per-worker state
(a collective), so rank 0's file is the stacked Trainer's, and a restore
gives each rank its own row.

The comm decides where the workers live: ``StackedComm`` (the default)
holds all P on one device; ``ProcessGroupComm`` one per process, the rank
being the worker's id. Each process runs its ``comm.local_workers``
workers, whose ids start at ``comm.first_worker``, and every process draws
the same global batch and keeps its workers' rows. Across processes the
initial parameters are checked against rank 0's by a broadcast (the
reference broadcasts them, ``VGG/main_trainer.py:52-54``; here they are
already equal from the seed), and after each step the BatchNorm
statistics are rank 0's on every rank (one small broadcast).

One step:
1. each of the P workers runs forward/backward on its shard of the global
   batch: shard p is ``nsteps_update * b`` contiguous rows, split in order
   into ``nsteps_update`` microbatches of b rows whose gradients add up
   (as the JAX step's ``lax.scan`` does); the sum and the loss are divided
   by ``nsteps_update``;
2. its gradient is written into row p of a flat [P, n] buffer in the JAX
   package's leaf order and layout (the model's ``jax_leaves``) — one
   n-scale copy per worker — so buckets, regions and selections match the
   reference's; with ``grad_clip`` each row is scaled by
   ``min(1, grad_clip / (||row|| + 1e-12))``;
3. the sparse collective (``optim/distributed.py``) reduces it;
4. the optimizer updates the (single, replicated) parameters from the
   result: SGD (VGG, the LSTMs) leaf by leaf, momentum-free under momentum
   correction (the momentum is then folded into the compressed gradient
   stream); BertAdam (BERT) over the flat buffers.

The workload (``workload(cfg.dnn)``) decides the batch keys, the loss
and the optimizer, as in the JAX Trainer:
- ``image`` (VGG and the rest of the CNN zoo): ``image``, ``label``;
  softmax cross entropy; SGD;
- ``bert`` (``bert*``): ``input_ids``, ``token_type_ids``,
  ``attention_mask``, ``mlm_labels``, ``nsp_labels``;
  ``bert_pretrain_loss`` (``mlm_loss`` and ``nsp_loss`` join the
  metrics); BertAdam with ``t_total = cfg.total_steps or -1``; momentum
  correction ignored with the JAX warning;
- ``lm`` (``lstm``, ``lstm_tiny``): ``tokens``, ``targets``;
  ``lm_cross_entropy``; SGD; every step from a zero carry (the JAX
  Trainer ignores the carry its model returns);
- ``ctc`` (``lstman4*``): ``spect``, ``spect_lengths``, ``labels``,
  ``label_lengths``; ``ctc_loss`` over ``ctc_frame_len(spect_lengths)``
  capped at the logits' frames; SGD.
BatchNorm running statistics (the CNNs, DeepSpeech) come from worker 0's
microbatches, in order, as the JAX step returns them (``out_specs=P()``
takes shard 0). The reported losses are the means of the P worker
losses, added in rank order.

Dropout (BERT, the PTB LSTM) draws JAX's own masks through the JAX
step's key chain (``ops/prng.py``, on the host): the Trainer's key starts
at ``PRNGKey(seed + 1)`` and is split every step into the next key and
the step's key (``oktopk_tpu/train/trainer.py:231,631``); worker p folds
its index into the step's key (``optim/distributed.py:261``) and splits
that once per microbatch (:266), the second half being the apply's
dropout key, from which each dropout site takes flax's key
(``models/layers.py``). Worker p's masks so depend on (seed, step, p,
microbatch) alone, not on P, and a rank derives its own workers' keys
without the others'.

``cfg.compute_dtype`` is flax's ``dtype`` (the JAX Trainer's :77-81):
"bfloat16" gives the model ``dtype=torch.bfloat16``, whose layers cast
their inputs and float32 parameters to bfloat16 at every call
(``models/layers.py``). The parameters, their gradients, the flat
buffer, the sparse collective and the optimizer state stay float32
(checked: ``master_dtypes``); the logits, and so every loss, are
float32.

On the card TF32 is switched off for cuDNN convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` set False), so the float32
model computes in float32 as the reference does; cuBLAS may not reduce
a bfloat16 product's split-K partial sums in bfloat16
(``allow_bf16_reduced_precision_reduction`` False: XLA accumulates in
float32); and cuDNN is made deterministic
(``torch.backends.cudnn.deterministic`` True, ``benchmark`` False), so
a run repeats as XLA's does; all five switches are process-wide.
cuBLAS repeats only with ``CUBLAS_WORKSPACE_CONFIG`` set before the
CUDA context exists (``main_trainer.main`` sets it).

With ``cfg.resilience`` the Trainer runs the JAX Trainer's resilience
surface (:172-217, :429-557, :801-870): the step's anomaly guard
(``SparseGradStep(guard=...)``), a ``Supervisor`` whose
``HealthJournal`` rides the run's bus, with
``cfg.resilience_density_backoff`` a ``DensityBackoff``, and
``fault_plan`` (a ``resilience.FaultPlan``) announced as ``fault_seen``
``planned:<kind>`` events and injected by the step. A skipped step
leaves the parameters, the optimizer state and the BatchNorm
statistics bit-identical: ``train_step`` snapshots them (the statistics
before worker 0's forward, which updates them) and restores them with
``torch.where`` on the step's device flag, so the guard adds no host
sync; the host reads the flags only in ``supervise``, every
``cfg.resilience_check_every`` steps, before the quality flush as in
JAX's loop (:691-703). A dense fallback or a density backoff level
re-plans the step (``SparseGradStep.replan``: residuals, momenta, rings
and health kept); a restore goes through ``train/durable.py``'s
``verified_restore``; a chip loss shrinks the stacked comm
(``resize_workers``). Checkpoints carry the health counters
(``convert.py``) and the supervisor's state (``supervisor_extra``,
``restore_supervisor``).

With ``cfg.autotune`` the Trainer runs the JAX Trainer's autotuner
(:337-427): ``maybe_autotune`` before each step tunes on first use and
on ``cfg.autotune_retune_every``; ``autotune`` runs calibrate -> trial ->
policy over the buckets (``autotune/``: the comm's ``pmean`` probes, the
candidates' collectives timed on the device, or the ``fake_ms`` seam)
and re-plans the step only when ``Autotuner.plans_changed`` says so.
``_replan`` resolves in JAX's ``_build_step`` order (:242-283): the
plan's per-bucket algorithm and density, then the density backoff's
scale, then the supervisor's dense fallbacks; the step keeps every state
across a re-plan. With ``cfg.resilience_feedback`` (and a bus) an
``AutotuneFeedback`` votes on the bus's ``regression`` and
``guard_trip`` events (and breached ``quality_rollup``s under
``cfg.obs_quality``); ``check_feedback``, after the quality flush, fires
``force_retune``: a ``retune`` event, the tuner dropped, a fresh
calibration and plan. Across processes every rank runs the probes and
trials in the same order and decides on medians agreed over the ranks
(``autotune/calibrate.py``), and the feedback vote is agreed by one
small psum, so a regression seen on one rank re-tunes every rank.

``profile_norm`` defaults to ``settings.PROFILING_NORM``
(``OKTOPK_PROFILING_NORM``), as the JAX Trainer's (:64-66).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile
import time
import warnings
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from oktopk_tpu_torch import resolve_device
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import (from_jax_params,
                                      load_train_state_from_jax,
                                      train_state_to_jax)
from oktopk_tpu_torch.models import create_model
from oktopk_tpu_torch.models.deepspeech import CONV_TIME_STRIDE
from oktopk_tpu_torch.models.layout import from_jax_layout, to_jax_layout
from oktopk_tpu_torch.obs import volume as obs_volume
from oktopk_tpu_torch.obs.anatomy import (STEP, backward_scope,
                                          phase_scope, span)
from oktopk_tpu_torch.obs.journal import EventBus, RunJournal
from oktopk_tpu_torch.obs.metrics_buffer import rows_since
from oktopk_tpu_torch.obs.quality import QualityConfig, quality_event
from oktopk_tpu_torch.obs.regress import RegressionDetector
from oktopk_tpu_torch.obs.rollup import RollupEngine
from oktopk_tpu_torch.obs.tracing import AnomalyTracer
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.optim import SGD, BertAdam
from oktopk_tpu_torch.optim.distributed import SparseGradStep, flat_size
from oktopk_tpu_torch.resilience import (AutotuneFeedback, DensityBackoff,
                                         GuardConfig, HealthJournal,
                                         Supervisor)
from oktopk_tpu_torch.resilience.faults import dead_workers
from oktopk_tpu_torch.resilience.supervisor import plan_with_fallbacks
from oktopk_tpu_torch.train import losses

BATCH_KEYS = {
    "image": ("image", "label"),
    "bert": ("input_ids", "token_type_ids", "attention_mask", "mlm_labels",
             "nsp_labels"),
    "lm": ("tokens", "targets"),
    "ctc": ("spect", "spect_lengths", "labels", "label_lengths"),
}


def workload(dnn: str) -> str:
    """The workload family of a model name (a key of ``BATCH_KEYS``)."""
    if dnn.startswith("bert"):
        return "bert"
    if dnn in ("lstm", "lstm_tiny"):
        return "lm"
    if dnn.startswith("lstman4"):
        return "ctc"
    return "image"


def ctc_frame_len(spect_lengths: torch.Tensor) -> torch.Tensor:
    """Input-spectrogram frames -> logit frames: the conv frontend
    downsamples time by ``CONV_TIME_STRIDE`` (rounding up), as
    ``oktopk_tpu/train/trainer.py::_ctc_frame_len`` (:44-53)."""
    s = CONV_TIME_STRIDE
    return (spect_lengths + s - 1) // s


def _host_metrics(metrics, keys) -> Dict[str, np.ndarray]:
    """``metrics[k]`` of the ``keys`` present, as host arrays: device
    tensors in one copy (float64 holds int32 and float32 exactly),
    anything else as given."""
    keys = [k for k in keys if k in metrics]
    dev = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    out = {k: np.asarray(metrics[k]) for k in keys if k not in dev}
    if dev:
        flat = torch.cat([metrics[k].reshape(-1).to(torch.float64)
                          for k in dev]).cpu().numpy()
        off = 0
        for k in dev:
            t = metrics[k]
            out[k] = flat[off:off + t.numel()].reshape(tuple(t.shape)).astype(
                torch.empty((), dtype=t.dtype).numpy().dtype)
            off += t.numel()
    return out


def _lecun_normal_(p: torch.Tensor, fan_in: int, gen: torch.Generator):
    with torch.no_grad():
        w = torch.randn(p.shape, generator=gen) * math.sqrt(1.0 / fan_in)
        p.copy_(w)


class Trainer:
    """Data-parallel training over ``cfg.num_workers`` workers, every
    gradient through ``cfg.compressor``; ``comm`` defaults to all of them
    stacked on one device."""

    def __init__(self, cfg: TrainConfig,
                 algo_cfg: Optional[OkTopkConfig] = None, device=None,
                 warmup: bool = True,
                 model_kwargs: Optional[Dict[str, Any]] = None,
                 profile_norm: Optional[bool] = None, comm=None,
                 fault_plan=None):
        from oktopk_tpu_torch import settings
        if profile_norm is None:
            profile_norm = settings.PROFILING_NORM
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            matmul = torch.backends.cuda.matmul
            matmul.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.cfg = cfg
        self.workload = workload(cfg.dnn)
        P = cfg.num_workers
        self.comm = StackedComm(P) if comm is None else comm
        if self.comm.size != P:
            raise ValueError(f"comm of {self.comm.size} workers for "
                             f"cfg.num_workers={P}")
        W = self.comm.local_workers
        self.distributed = W < P
        mk = dict(model_kwargs or {})
        if cfg.compute_dtype != "float32":
            mk.setdefault("dtype", getattr(torch, cfg.compute_dtype))
        model = create_model(cfg.dnn, **mk)
        gen = torch.Generator().manual_seed(cfg.seed)
        if hasattr(model, "init_weights"):
            model.init_weights(gen)
        else:
            for m in model.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                    # fan-in in/groups * kh * kw for a grouped kernel
                    _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                    if m.bias is not None:          # the ResNets' convs
                        torch.nn.init.zeros_(m.bias)
        self.model = model.to(self.device)
        self.leaves = self.model.jax_leaves()
        self.params = [p for _, p, _ in self.leaves]
        self.jax_shapes = [tuple(to_jax_layout(p, lay).shape)
                           for _, p, lay in self.leaves]
        offs = [0]
        for p in self.params:
            offs.append(offs[-1] + p.numel())
        self.offsets = offs
        n = flat_size(self.params)
        self.algo_cfg = (algo_cfg or OkTopkConfig()).replace(
            n=n, num_workers=P, density=cfg.density)
        if self.workload == "bert":
            if cfg.momentum_correction:
                warnings.warn(
                    "momentum_correction is an SGD-path feature (reference "
                    "VGG/distributed_optimizer.py:56,81-88); ignored for "
                    "BERT/Adam workloads", stacklevel=2)
            mc = 0.0
            self.optimizer = BertAdam(lr=cfg.lr, warmup=cfg.warmup_proportion,
                                      t_total=cfg.total_steps or -1)
            self.optimizer.init(n, self.device)
        else:
            mc = cfg.momentum if cfg.momentum_correction else 0.0
            self.optimizer = SGD(cfg.lr, momentum=0.0 if mc else cfg.momentum,
                                 weight_decay=cfg.weight_decay,
                                 nesterov=cfg.nesterov)
            self.optimizer.init(self.params)
        # ---- the run journal (obs/) ----------------------------------
        self.bus = None
        self.run_journal = None
        self.regress = None
        self.rollup = None
        self.tracer = None
        self._quality_cfg = None
        self.quality_flushes = 0   # host drains of the quality rings
        self._q_cursors = {}       # bucket -> last drained ring cursor
        if cfg.obs:
            self.bus = EventBus()
            self.run_journal = RunJournal(cfg.obs_journal, bus=self.bus)
            if cfg.obs_quality:
                # journal first, rollup engine second: the engine's
                # nested emit then lands each quality_rollup directly
                # after its quality event in the file
                self._quality_cfg = QualityConfig(
                    every=cfg.obs_quality_every,
                    sig_bins=cfg.obs_quality_sig_bins)
                self.rollup = RollupEngine(
                    self.bus,
                    growth_limit=cfg.obs_quality_growth_limit,
                    collapse_ratio=cfg.obs_quality_collapse_ratio,
                    churn_limit=cfg.obs_quality_churn_limit,
                    comp_err_limit=cfg.obs_quality_comp_err_limit,
                    on_breach=self._on_quality_breach)
            if cfg.obs_trace_on_anomaly:
                tdir = cfg.obs_trace_dir
                if tdir is None:
                    tdir = (os.path.join(os.path.dirname(
                                os.path.abspath(cfg.obs_journal)), "traces")
                            if cfg.obs_journal
                            else tempfile.mkdtemp(prefix="oktopk_traces_"))
                self.tracer = AnomalyTracer(
                    tdir, bus=self.bus, num_steps=cfg.obs_trace_steps,
                    max_captures=cfg.obs_max_traces,
                    rank=self.comm.first_worker)
            if cfg.obs_regress_key:
                self.regress = RegressionDetector.from_bench_records(
                    key=cfg.obs_regress_key, bus=self.bus,
                    tolerance=cfg.obs_regress_tolerance,
                    phase_limits=cfg.obs_phase_limits)
        # ---- the numeric-health guard and supervisor (resilience/) ----
        self._fault_plan = fault_plan
        self._guard = None
        self.supervisor = None
        if cfg.resilience:
            self._guard = GuardConfig(abs_limit=cfg.resilience_abs_limit)
            self.supervisor = Supervisor(
                num_buckets=cfg.num_buckets,
                max_strikes=cfg.resilience_strikes,
                divergence_limit=cfg.resilience_divergence_limit,
                cooldown_steps=cfg.resilience_cooldown,
                journal=HealthJournal(cfg.resilience_journal,
                                      bus=self.bus))
            if fault_plan is not None:
                # a drill: the planned schedule up front, so the journal
                # tells drills from real corruption
                for f in fault_plan.faults:
                    self.supervisor.journal.fault_seen(
                        f.step, f"planned:{f.kind}", buckets=[f.bucket])
        # ---- the closed-loop policies (resilience/feedback.py, density.py)
        self.feedback = None
        if cfg.resilience_feedback and self.bus is not None:
            kinds = ("regression", "guard_trip")
            if self._quality_cfg is not None:
                # breached quality rollups vote alongside guard trips and
                # step-time regressions
                kinds = kinds + ("quality_rollup",)
            self.feedback = AutotuneFeedback(
                self.bus, window_steps=cfg.resilience_feedback_window,
                min_signals=cfg.resilience_feedback_signals,
                cooldown_steps=cfg.resilience_feedback_cooldown,
                kinds=kinds)
        self.density_backoff = None
        if cfg.resilience and cfg.resilience_density_backoff:
            self.density_backoff = DensityBackoff(
                abs_limit=cfg.resilience_abs_limit,
                near_ratio=cfg.resilience_near_ratio,
                backoff_steps=cfg.resilience_backoff_steps,
                factor=cfg.resilience_backoff_factor,
                max_level=cfg.resilience_backoff_max_level,
                clean_streak=cfg.resilience_clean_streak)
        self._density_scale = 1.0  # the density backoff's multiplier
        self.retune_events = 0     # forced re-calibrations executed
        self._fake_ms = None       # the remembered trial-timing injector
        self.autotuner = None      # built on first use by autotune()
        self._plans = None         # per-bucket BucketPlan list, or None
        self._warmup, self._mc, self._profile_norm = warmup, mc, profile_norm
        self.grad_step = self._new_grad_step()
        self.flat = torch.empty((W, n), dtype=torch.float32,
                                device=self.device)
        self._rng = prng.prng_key(cfg.seed + 1)
        self.last_step = 0
        self.last_hypotheses = []      # eval_step's, DeepSpeech only
        self.stats = list(self.model.buffers())
        bad = {k: d for k, d in self.master_dtypes().items()
               if not d <= {torch.float32}}
        if bad:
            raise TypeError(f"master state not float32: {bad}")
        if self.distributed:
            changed = self.comm.replicate_(self.params).reshape(1, 1)
            if int(self.comm.psum(changed)[0, 0]):
                raise RuntimeError("initial parameters differ from rank "
                                   "0's; every rank must use the same seed")

    def _new_grad_step(self) -> SparseGradStep:
        """The step over the current comm, fresh per-worker state."""
        return SparseGradStep(
            self.algo_cfg, self.comm, self.params, self.cfg.compressor,
            self.cfg.num_buckets, warmup=self._warmup, device=self.device,
            momentum_correction=self._mc, profile_norm=self._profile_norm,
            quality=self._quality_cfg, guard=self._guard,
            fault_plan=self._fault_plan)

    @property
    def _forced_dense(self):
        return self.supervisor.forced_dense if self.supervisor else ()

    def _replan(self) -> None:
        """The JAX Trainer's ``_build_step`` (:242-283) as a re-plan of
        the step, in its order: the autotune plan's per-bucket algorithm
        and density; then the density backoff's scale on the schedule
        (capacity sizing pinned to ``cfg.density``) or on the per-bucket
        densities; then the supervisor's dense fallbacks, at density 1.0.
        The step keeps every state."""
        nb = max(1, self.cfg.num_buckets)
        compressor = self.cfg.compressor
        densities = None
        if self._plans:
            compressor = [p.algo for p in self._plans]
            densities = [p.density for p in self._plans]
        acfg = self.algo_cfg
        if self._density_scale < 1.0:
            if acfg.density_schedule:
                acfg = acfg.replace(density_schedule=tuple(
                    (s, d * self._density_scale)
                    for s, d in acfg.density_schedule))
            else:
                densities = [d * self._density_scale for d in
                             (densities if densities is not None
                              else [self.cfg.density] * nb)]
        if self._forced_dense:
            names = (list(compressor) if not isinstance(compressor, str)
                     else [compressor] * nb)
            compressor = plan_with_fallbacks(names, self._forced_dense)
            if densities is not None:
                densities = [1.0 if b in self._forced_dense else d
                             for b, d in enumerate(densities)]
        self.grad_step.replan(compressor, densities, acfg)

    def load_jax_variables(self, params_np, batch_stats_np=None) -> None:
        """Take the flax model's weights (``convert.from_jax_params``)."""
        sd = from_jax_params(params_np, batch_stats_np, model=self.model)
        self.model.load_state_dict(sd, strict=batch_stats_np is not None
                                   or not self.stats)

    def _jax_views(self, flat: torch.Tensor):
        """Each parameter's segment of the flat [n] ``flat``, viewed in the
        torch layout."""
        return [from_jax_layout(flat[s:e].view(shp), lay)
                for (_, _, lay), shp, s, e in zip(
                    self.leaves, self.jax_shapes, self.offsets[:-1],
                    self.offsets[1:])]

    def _write_flat_grad(self, w: int) -> None:
        for view, p in zip(self._jax_views(self.flat[w]), self.params):
            if p.grad.dtype != torch.float32:    # copy_ would cast it
                raise TypeError(f"gradient of dtype {p.grad.dtype}")
            view.copy_(p.grad)

    def master_dtypes(self) -> Dict[str, set]:
        """The dtypes of the float32 master state: ``params``, ``grads``
        (those present), ``flat`` (the [W, n] gradient buffer) and
        ``optimizer`` (its float tensors: SGD's momentum, BertAdam's
        moments)."""
        opt = [getattr(self.optimizer, k, None) for k in ("m", "v")]
        opt += list(getattr(self.optimizer, "momentum_buf", None) or [])
        return {"params": {p.dtype for p in self.params},
                "grads": {p.grad.dtype for p in self.params
                          if p.grad is not None},
                "flat": {self.flat.dtype},
                "optimizer": {t.dtype for t in opt if t is not None}}

    def microbatch_keys(self, step_key) -> np.ndarray:
        """[W, nsteps_update, 2] uint32: the dropout key of each of this
        process's workers' microbatches under the step's key, as the
        JAX step derives them (fold in the worker's index, then split
        once per microbatch, carrying the first half)."""
        first, W = self.comm.first_worker, self.comm.local_workers
        rng = prng.fold_in(step_key[None, :],
                           np.arange(first, first + W, dtype=np.uint32))
        out = []
        for _ in range(self.cfg.nsteps_update):
            pair = prng.split(rng)
            rng = pair[:, 0]
            out.append(pair[:, 1])
        return np.stack(out, axis=1)

    def _loss(self, mb, w: int, key):
        """(loss, {aux metrics}) of worker ``w`` on microbatch ``mb``
        under the dropout key ``key``."""
        if self.workload == "bert":
            mlm, nsp = self.model(mb["input_ids"], mb["token_type_ids"],
                                  mb["attention_mask"], train=True,
                                  rng=key)
            return losses.bert_pretrain_loss(mlm, nsp, mb["mlm_labels"],
                                             mb["nsp_labels"])
        if self.workload == "lm":
            logits = self.model(mb["tokens"], train=True, rng=key)
            return losses.lm_cross_entropy(logits, mb["targets"]), {}
        if self.workload == "ctc":
            logits = self.model(mb["spect"], train=True,
                                update_stats=(w == 0))
            frames = torch.clamp(ctc_frame_len(mb["spect_lengths"]),
                                 max=logits.shape[1])
            return losses.ctc_loss(logits, frames, mb["labels"],
                                   mb["label_lengths"]), {}
        logits = self.model(mb["image"], train=True, update_stats=(w == 0))
        return losses.softmax_cross_entropy(logits, mb["label"]), {}

    def _opt_snapshot(self) -> Dict[str, Any]:
        """The optimizer state a skipped step must leave as it was: the
        tensors it replaces (BertAdam's m, v, step; SGD's step) by
        reference, the ones it updates in place (SGD's momentum) as
        copies."""
        opt = self.optimizer
        if isinstance(opt, BertAdam):
            return {"step": opt.step, "m": opt.m, "v": opt.v}
        return {"step": opt.step,
                "momentum_buf": [b.clone() for b in opt.momentum_buf or []]}

    @torch.no_grad()
    def _roll_back(self, skip: torch.Tensor, params, opt_old, stats) -> None:
        """On a skipped step (``skip``, a 0-d device flag) put the
        parameters, the optimizer state and the BatchNorm statistics
        back, bit for bit; otherwise leave them. No host sync."""
        for p, old in zip(self.params, params):
            p.copy_(torch.where(skip, old, p))
        for b, old in zip(self.stats, stats):
            b.copy_(torch.where(skip, old, b))
        opt = self.optimizer
        opt.step = torch.where(skip, opt_old["step"], opt.step)
        if isinstance(opt, BertAdam):
            opt.m = torch.where(skip, opt_old["m"], opt.m)
            opt.v = torch.where(skip, opt_old["v"], opt.v)
            return
        for b, old in zip(opt.momentum_buf or [], opt_old["momentum_buf"]):
            b.copy_(torch.where(skip, old, b))

    @torch.no_grad()
    def _apply_update(self, reduced: torch.Tensor) -> None:
        if self.workload != "bert":
            self.optimizer.update(self.params, self._jax_views(reduced))
            return
        flat_p = torch.empty_like(reduced)
        for view, p in zip(self._jax_views(flat_p), self.params):
            view.copy_(p)
        upd = self.optimizer.update(reduced, flat_p)
        for view, p in zip(self._jax_views(upd), self.params):
            p.add_(view)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One data-parallel step on a global batch (dict of arrays with a
        leading [P * nsteps_update * b] dimension), of which this process
        takes its workers' rows. Metrics stay on the device."""
        with span(STEP, root=True):
            return self._train_step(batch)

    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        P, W = self.comm.size, self.comm.local_workers
        first = self.comm.first_worker
        ns = self.cfg.nsteps_update
        keys = BATCH_KEYS[self.workload]
        rows_total = len(batch[keys[0]])
        b = rows_total // (P * ns)
        if b * P * ns != rows_total:
            raise ValueError(f"global batch {rows_total} is not a "
                             f"multiple of {P} workers x {ns} microbatches")
        lo, hi = first * ns * b, (first + W) * ns * b
        data = {k: torch.as_tensor(batch[k][lo:hi]).to(self.device)
                for k in keys}
        # worker 0's forward updates the BatchNorm statistics
        stats_old = ([b.clone() for b in self.stats]
                     if self._guard is not None else None)
        pair = prng.split(self._rng)
        self._rng = pair[0]
        mb_keys = self.microbatch_keys(pair[1])
        worker = []
        with phase_scope("fwd_bwd"):
            for i in range(W):
                for p in self.params:
                    p.grad = None
                sums = {}
                for j in range(ns):  # autograd adds the microbatch grads
                    rows = slice((i * ns + j) * b, (i * ns + j + 1) * b)
                    loss, aux = self._loss(
                        {k: v[rows] for k, v in data.items()}, first + i,
                        mb_keys[i, j])
                    backward_scope(loss).backward()
                    for k, v in {"loss": loss, **aux}.items():
                        sums[k] = sums.get(k, 0.0) + v.detach()
                self._write_flat_grad(i)
                worker.append({k: v / ns for k, v in sums.items()})
            if ns > 1:
                self.flat.div_(ns)
            if self.cfg.grad_clip is not None:
                norm = torch.sqrt(torch.sum(self.flat * self.flat, 1,
                                            keepdim=True))
                self.flat.mul_(torch.clamp(
                    self.cfg.grad_clip / (norm + 1e-12), max=1.0))
        reduced, metrics, skip = self.grad_step(self.flat)
        if skip is not None:
            params_old = [p.detach().clone() for p in self.params]
            opt_old = self._opt_snapshot()
        with phase_scope("optimizer"):
            self._apply_update(reduced)
        if skip is not None:
            self._roll_back(skip, params_old, opt_old, stats_old)
        for p in self.params:
            p.grad = None
        if self.distributed and self.stats:
            self.comm.replicate_(self.stats)        # worker 0's (H7)
        names = list(worker[0])
        total = self.comm.psum(torch.stack(
            [torch.stack([wm[k] for k in names]) for wm in worker]))[0]
        means = dict(zip(names, (total / P).unbind(0)))
        return {**means, **metrics}

    def train(self, data_iter: Iterable, num_iters: int, log_every: int = 50,
              logger: Optional[logging.Logger] = None, metric_writer=None,
              timers=None, trace=None, start_step: int = 0,
              should_stop=None) -> Dict[str, float]:
        """Run ``num_iters`` steps (the JAX Trainer's loop, :635-754);
        returns the last step's metrics on the host (empty when no step
        ran). ``should_stop`` is polled before each step, and a True stops
        the loop between steps (the JAX Trainer's preemption hook); across
        processes the ranks agree on it (one small psum a step), so all
        stop at the same step. ``last_step`` is the last step run.

        ``metric_writer`` (``utils.profiling.MetricWriter``) records every
        step's metrics and the bus journals them as ``step`` events, both
        from a pending list drained on the log cadence (one copy to the
        host a drain); ``timers`` (``PhaseTimers``) splits data wait from
        the step, the card synchronised inside the ``step`` phase, and its
        summary is journalled as a ``phase`` event on the log cadence;
        ``trace`` (``TraceWindow``) captures a bounded profiler window."""
        metrics = {}
        pending = []    # (step, device metrics), drained on the log cadence
        nf_window = []  # per-step nonfinite counts (device scalars)

        def flush_pending():
            if not pending:
                return
            names = list(pending[0][1])
            # a per-bucket metric is journalled as its mean, as JAX does
            host = torch.stack([torch.stack([m[k].to(torch.float64).mean()
                                             for k in names])
                                for _, m in pending]).cpu().tolist()
            for (s, _), vals in zip(pending, host):
                row = dict(zip(names, vals))
                if metric_writer is not None:
                    metric_writer.write(s, row)
                if self.bus is not None:
                    self.bus.emit("step", step=s, **row)
            pending.clear()

        t0 = time.time()
        self.last_step = start_step
        for i in range(num_iters):
            if should_stop is not None and self._agree(should_stop()):
                break
            step = start_step + i + 1
            self.last_step = step
            # plan (or re-plan) the per-bucket collectives before the
            # step runs; a no-change verdict leaves the step as it is
            self.maybe_autotune(step)
            if trace is not None:
                trace.on_step(step)
            if self.tracer is not None:
                # the anomaly-armed window opens on the step after a
                # guard_trip / fallback / breached rollup and closes
                # num_steps later with a trace_captured event
                self.tracer.on_step(step)
            if timers is not None:
                with timers.phase("data"):
                    batch = next(data_iter)
                with timers.phase("step"):
                    metrics = self.train_step(batch)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            else:
                metrics = self.train_step(next(data_iter))
            if (self.supervisor is not None
                    and step % max(1, self.cfg.resilience_check_every) == 0):
                # the host reads the guard's flags on this cadence only;
                # an escalation may re-plan the step or restore state
                self.supervise(step, metrics)
            if (self._quality_cfg is not None
                    and step % self._quality_cfg.every == 0):
                # the rings are drained on their own cadence only
                self._flush_quality(step)
            if self.feedback is not None:
                # the fault -> autotune feedback: a passing window vote
                # forces a re-calibrate and re-tune
                self.check_feedback(step)
            if metric_writer is not None or self.bus is not None:
                pending.append((step, metrics))
            if "grad_nonfinite" in metrics:
                nf_window.append(metrics["grad_nonfinite"])
            if (i + 1) % log_every == 0:
                flush_pending()
                dt = (time.time() - t0) / log_every
                if self.regress is not None:
                    self.regress.observe(step, dt * 1e3)
                if logger is not None:
                    logger.info("iter %d loss %.4f vol %.0f %.3fs/it", step,
                                float(metrics["loss"]),
                                float(metrics["comm_volume"]), dt)
                    nf = int(torch.stack(nf_window).sum()) if nf_window \
                        else 0
                    if nf:
                        logger.warning(
                            "window ending iter %d: %d nonfinite gradient "
                            "elements", step, nf)
                nf_window.clear()
                if timers is not None and self.bus is not None:
                    phase_summary = timers.summary()
                    self.bus.emit("phase", step=step, phases=phase_summary)
                    if self.regress is not None:
                        self.regress.observe_phases(step, phase_summary)
                t0 = time.time()
            if timers is not None and logger is not None:
                timers.maybe_log(step, logger)
        flush_pending()
        if self.tracer is not None:
            self.tracer.finish(self.last_step)
        if self._quality_cfg is not None:
            # the tail of the run, a partial window
            self._flush_quality(self.last_step)
        if self.bus is not None:
            self._emit_volume_report()
        return {k: float(v.to(torch.float64).mean())
                for k, v in metrics.items()}

    # ---- the run journal ------------------------------------------------

    def _bucket_plan(self):
        """Per-bucket (algo name, density) for the reports (the JAX
        Trainer's, :757), read off the step as ``_replan`` left it (the
        autotune plans, the backoff's scale, the fallbacks); a dense
        fallback reports density 1.0."""
        gs = self.grad_step
        densities = [1.0 if b in self._forced_dense else c.density
                     for b, c in enumerate(gs.cfgs)]
        return list(gs.names), densities

    def _flush_quality(self, step: int) -> None:
        """Drain the quality rings to the journal (the JAX Trainer's,
        :285): every bucket's ring and cursor, every worker's rows (an
        all_gather across processes, so each rank journals the same),
        in one copy to the host; each bucket's new rows become a
        ``quality`` event, which the rollup engine at once rolls up."""
        if self._quality_cfg is None or self.bus is None:
            return
        names, densities = self._bucket_plan()
        if self.rollup is not None:
            self.rollup.target_densities = [float(d) for d in densities]
        qs = self.grad_step.qualities
        W = self.comm.local_workers
        # the int32 cursor rides bit for bit as a float32 column
        packed = torch.cat([t for q in qs for t in (
            q.ring.reshape(W, -1), q.cursor.view(torch.float32)[:, None])],
            1)
        host = self.comm.all_gather(packed)[0].cpu().numpy()
        off = 0
        for b, q in enumerate(qs):
            size = q.ring[0].numel()
            ring = host[:, off:off + size].reshape(
                (host.shape[0],) + tuple(q.ring.shape[1:]))
            cursor = int(host[0, off + size:off + size + 1].view(np.int32)[0])
            off += size + 1
            prev = self._q_cursors.get(b, 0)
            if cursor == prev:
                continue
            rows = rows_since(ring, cursor, prev)
            self._q_cursors[b] = cursor
            algo = names[b] if b < len(names) else self.cfg.compressor
            self.bus.emit("quality", **quality_event(step, b, algo, rows))
        self.quality_flushes += 1

    def _on_quality_breach(self, step: int, bucket: int, breaches) -> None:
        """The rollup engine's breach hook (the JAX Trainer's, :311-333):
        sustained FIDELITY breaches go to the density backoff, which
        advances its level back up (guard pressure pushes density down,
        compression-quality pressure pulls it back up); without a
        backoff it returns, the breach staying in the rollup's
        ``breaches``."""
        if self.density_backoff is None:
            return
        change = None
        for kind in breaches:
            change = self.density_backoff.note_quality_breach(
                int(step), str(kind)) or change
        if change is not None:
            self._density_scale = float(change["scale"])
            self.supervisor.journal.density_backoff(int(step), **change)
            self._replan()

    def _emit_volume_report(self) -> None:
        """One ``volume_report`` event per bucket (the JAX Trainer's,
        :775): worker 0's mean wire bytes per step over the whole run
        (dense warmup steps and exact recomputes included) against the
        algorithm's analytic budget (``obs/volume.py``)."""
        names, densities = self._bucket_plan()
        for b, (nm, dens) in enumerate(zip(names, densities)):
            sp = self.grad_step.states[b]
            # worker 0's row, on every rank
            steps_done, wb = self.comm.all_gather(torch.stack(
                [sp.step.to(torch.float64),
                 sp.wire_bytes.to(torch.float64)], 1))[0, 0].tolist()
            steps_done = int(steps_done)
            cfg_b = self.algo_cfg.replace(n=int(sp.residual.shape[-1]),
                                          density=float(dens))
            rep = obs_volume.volume_report(
                nm, cfg_b, wb / max(1, steps_done), bucket=b,
                step=self.last_step, steps=steps_done)
            self.bus.emit("volume_report", **rep)

    # ---- autotuning ---------------------------------------------------

    def _make_autotuner(self, fake_ms=None):
        """The JAX Trainer's (:337-360): candidates from
        ``cfg.autotune_candidates`` crossed with ``cfg.autotune_densities``
        (or ``cfg.density``), a ``TrialRunner`` over the comm on the
        Trainer's device, the buckets' sizes (``bucket_sizes`` over
        ``bucket_partition``, JAX's) and a decision journal on the bus."""
        from oktopk_tpu_torch.autotune import (Autotuner, AutotunePolicy,
                                               DecisionJournal, TrialRunner)
        from oktopk_tpu_torch.autotune.policy import make_candidates
        from oktopk_tpu_torch.optim.distributed import (bucket_partition,
                                                        bucket_sizes)

        cfg = self.cfg
        densities = tuple(cfg.autotune_densities) or (cfg.density,)
        policy = AutotunePolicy(
            candidates=make_candidates(cfg.autotune_candidates, densities),
            hysteresis=cfg.autotune_hysteresis,
            retune_every=cfg.autotune_retune_every,
            max_trials=cfg.autotune_max_trials)
        runner = TrialRunner(
            comm=self.comm, trial_steps=cfg.autotune_trial_steps,
            seed=cfg.seed, base_cfg=self.algo_cfg, fake_ms=fake_ms,
            device=self.device)
        sizes = bucket_sizes(self.params, bucket_partition(
            self.params, cfg.num_buckets))
        return Autotuner(
            sizes, cfg.num_workers, policy, runner,
            journal=DecisionJournal(cfg.autotune_journal, bus=self.bus))

    def autotune(self, step: int = 0, fake_ms=None):
        """Run (or re-run) the calibrate -> trial -> policy pass and adopt
        the per-bucket plan (the JAX Trainer's, :362-385). The step is
        re-planned only when the plan changed: the policy's hysteresis
        keeps borderline buckets from re-planning every re-tune. Returns
        the plan list.

        ``fake_ms(algo, n, density) -> ms`` injects synthetic trial
        timings (``autotune/trial.py``); it is remembered, so a forced
        re-tune or an elastic resize keeps measuring through the same
        seam."""
        from oktopk_tpu_torch.autotune import Autotuner

        if fake_ms is not None:
            self._fake_ms = fake_ms
        if self.autotuner is None:
            self.autotuner = self._make_autotuner(fake_ms=self._fake_ms)
        old = self._plans
        self._plans = self.autotuner.tune(step=step, comm=self.comm)
        if Autotuner.plans_changed(self._plans, old):
            self._replan()
        return self._plans

    def maybe_autotune(self, step: int) -> None:
        """Tune on first use and on the configured re-tune cadence."""
        if not self.cfg.autotune:
            return
        if self.autotuner is None or self.autotuner.should_retune(step):
            self.autotune(step=step)

    def force_retune(self, step: int, trigger: str = "manual",
                     signals=()):
        """Drop the autotuner and re-tune from scratch (the JAX
        Trainer's, :394-413): the fault -> autotune feedback path. A
        fresh tuner has no fabric coefficients, so the next ``tune()``
        re-calibrates against the current (possibly degraded) fabric
        before re-deciding; the journal carries the chain ``retune``
        (with the evidence steps) -> ``calibration`` ->
        ``autotune_decision``. Returns the new plan (None with autotune
        off: the retune is still journalled)."""
        self.retune_events += 1
        if self.bus is not None:
            self.bus.emit("retune", step=int(step), trigger=str(trigger),
                          signals=[int(s) for s in signals],
                          cleared="autotuner")
        self.autotuner = None
        if self.cfg.autotune:
            return self.autotune(step=step)
        return None

    def check_feedback(self, step: int):
        """Poll the feedback policy and run the forced re-calibrate and
        re-tune when its window vote passes (the JAX Trainer's,
        :415-427). Returns the trigger descriptor, or None. Across
        processes the vote is agreed (``_agree_trigger``), so every rank
        re-tunes, with the same descriptor, when any rank's vote passes."""
        if self.feedback is None:
            return None
        trig = self.feedback.should_retune(step)
        if self.distributed:
            trig = self._agree_trigger(step, trig)
        if trig is not None:
            self.force_retune(step, trigger=trig["trigger"],
                              signals=trig["signals"])
        return trig

    def _agree_trigger(self, step: int, trig):
        """The feedback vote across processes: one psum of a [P] one-hot
        row says which ranks fired; when any did, the lowest one's
        descriptor goes to every rank (a broadcast), and a rank that did
        not fire takes the firing's bookkeeping
        (``AutotuneFeedback.note_peer_fire``), so every rank's window and
        cooldown stay in step."""
        fired = torch.zeros((1, self.comm.size), dtype=torch.int32,
                            device=self.device)
        if trig is not None:
            fired[0, self.comm.first_worker] = 1
        ranks = torch.nonzero(self.comm.psum(fired)[0]).flatten().tolist()
        if not ranks:
            return None
        agreed = self.comm.broadcast_object(trig, src=ranks[0])
        if trig is None:
            self.feedback.note_peer_fire(step)
        return agreed

    # ---- resilience supervision ---------------------------------------

    def supervise(self, step: int, metrics) -> None:
        """Feed one step's guard metrics to the supervisor and execute
        what it escalates to (the JAX Trainer's, :429-457): a dense
        fallback re-plans the step, a restore reloads the last good
        checkpoint, a chip loss (the plan's dead workers, polled here)
        shrinks the comm; then the density backoff digests the step's
        guard pressure. The flags come to the host in one copy."""
        if self.supervisor is None:
            return
        if self._fault_plan is not None:
            dead = dead_workers(self._fault_plan, step)
            if dead:
                for act in self.supervisor.note_chip_loss(step, dead):
                    self._execute_action(act, step)
        host = _host_metrics(metrics, ("step_skipped", "bucket_anomalies",
                                       "reduced_absmax"))
        for act in self.supervisor.observe(step, {
                k: host[k] for k in ("step_skipped", "bucket_anomalies")
                if k in host}):
            self._execute_action(act, step)
        if self.density_backoff is not None and "reduced_absmax" in host:
            change = self.density_backoff.observe(
                step, absmax=float(host["reduced_absmax"]),
                skipped=int(host.get("step_skipped", 0)))
            if change is not None:
                self._density_scale = float(change["scale"])
                self.supervisor.journal.density_backoff(step, **change)
                self._replan()

    def _execute_action(self, act, step: int) -> None:
        """Execute one supervisor escalation (the JAX Trainer's,
        :459-487)."""
        if act.kind == "fallback":
            # forced_dense already updated by the supervisor
            self._replan()
        elif act.kind == "restore":
            self._execute_restore(step, act.ckpt)
        elif act.kind == "remesh":
            self._execute_remesh(step, act.workers)

    def _execute_restore(self, step: int, ckpt) -> None:
        """Reload the last good checkpoint ``ckpt``. The candidates are
        walked newest -> oldest past corrupt files, each rejected one
        journalled before the ``restore`` record, so the journal names
        the file actually loaded.

        Across processes the registration and the walk are rank 0's,
        handed to every rank: an async write failure reaches rank 0's
        supervisor alone (its writer runs there), and a write that
        publishes during the walk could be seen by some ranks and not
        others. Every other rank then loads the file rank 0 chose."""
        from oktopk_tpu_torch.train.durable import verified_restore
        sup = self.supervisor
        journal = sup.journal
        lead = not self.distributed or self.comm.first_worker == 0
        if self.distributed:
            reg = self.comm.broadcast_object(
                (sup.last_good_ckpt, sup.last_good_step,
                 sup.ckpt_write_failures))
            if ckpt and reg[0] is None:
                # rank 0 journalled the unavailable restore in observe
                journal.restore(step, None, reg[1])
            (sup.last_good_ckpt, sup.last_good_step,
             sup.ckpt_write_failures) = reg
            ckpt = reg[0]
        if not ckpt:
            return
        template = self.train_state(gather=False)
        used = tree = None
        missing = FileNotFoundError(
            f"no restorable checkpoint at or before {ckpt!r}")
        if lead:
            try:
                tree, ckpt_step, used, _, _ = verified_restore(
                    ckpt, template, journal=journal, bus=self.bus,
                    step=step)
            except FileNotFoundError as e:
                missing = e
        if self.distributed:
            used = self.comm.broadcast_object(used)
            if used is not None and not lead:
                tree, ckpt_step, got, _, _ = verified_restore(
                    used, template, bus=self.bus, step=step)
                if got != used:
                    raise RuntimeError(f"rank 0 restored {used}, this "
                                       f"rank could only read {got}")
        if used is None:
            # every candidate corrupt: journal it and fail loudly rather
            # than keep training a diverged model
            journal.restore(step, None, -1)
            raise missing
        self.load_train_state(tree)
        journal.restore(step, used, ckpt_step)

    def _execute_remesh(self, step: int, workers) -> None:
        """Drop the dead workers and resize onto the survivors (the JAX
        Trainer's, :489-503): on the stacked comm a ``StackedComm`` of
        P - |dead| workers."""
        dead = sorted({int(w) for w in workers})
        if not isinstance(self.comm, StackedComm):
            raise NotImplementedError(
                "a chip loss remeshes the stacked comm only: a dead "
                "process cannot be dropped from a live process group")
        P = self.comm.size - len(dead)
        if P < 1:
            raise RuntimeError(
                f"chip_loss at step {step} left no surviving workers")
        self.resize_workers(StackedComm(P), trigger="chip_loss",
                            dead_workers=dead, step=step)

    def resize_workers(self, new_comm, trigger: str = "manual",
                       dead_workers=(), step: Optional[int] = None) -> None:
        """Re-build the step for a new world size, keeping the model and
        optimizer state (the JAX Trainer's, :801-870). Carried: the
        parameters, the BatchNorm statistics, the optimizer state, the
        health clock and the supervisor; re-initialised: the sparse
        states, the local momenta, the autotuner (its trials timed the
        old topology: dropped, so it re-tunes on the next cadence, while
        the plan is kept and the new step follows it) and the quality
        rings. Journalled as a ``remesh`` event
        naming both lists. Stacked comms only: JAX's remesh is its
        single controller's, and a dead process cannot be dropped from a
        live ``ProcessGroupComm``."""
        if not (isinstance(new_comm, StackedComm)
                and isinstance(self.comm, StackedComm)):
            raise NotImplementedError(
                "resize_workers needs stacked comms: a process group "
                "cannot drop a dead rank")
        old_world = int(self.cfg.num_workers)
        P = new_comm.size
        old_health = self.grad_step.health
        self.comm = new_comm
        self.cfg = dataclasses.replace(self.cfg, num_workers=P)
        self.algo_cfg = self.algo_cfg.replace(num_workers=P)
        self.grad_step = self._new_grad_step()
        self._replan()
        self.flat = torch.empty((P, self.algo_cfg.n), dtype=torch.float32,
                                device=self.device)
        carried = ["params", "model_state", "opt_state"]
        reinit = ["sparse_state", "local_momentum", "autotuner"]
        # the trials timed the old topology: drop the tuner, keep the plan
        self.autotuner = None
        if self._quality_cfg is not None:
            # fresh rings: the drained-cursor bookkeeping restarts too
            self._q_cursors = {}
            reinit.append("quality")
        if old_health is not None:
            # the fault plans' and the supervisor's clock stays monotonic
            self.grad_step.health = old_health
            carried.append("health")
        if self.supervisor is not None:
            carried.append("supervisor")
        ev = dict(step=int(step if step is not None else self.last_step),
                  old_world=old_world, new_world=P, trigger=str(trigger),
                  dead_workers=[int(w) for w in dead_workers],
                  carried=carried, reinitialised=reinit)
        if self.supervisor is not None:
            self.supervisor.journal.remesh(**ev)
        elif self.bus is not None:
            self.bus.emit("remesh", **ev)

    def note_checkpoint(self, path: str, step: int) -> None:
        """Register a saved checkpoint as a restore candidate: through
        the supervisor's journal with resilience on, straight onto the
        bus otherwise."""
        if self.supervisor is not None:
            self.supervisor.note_checkpoint(path, step)
        elif self.bus is not None:
            self.bus.emit("checkpoint", step=int(step), path=path,
                          qualified=True)

    @property
    def checkpoint_qualified(self) -> bool:
        """Whether a checkpoint taken now would be a restore target (no
        skips in flight): the manifest's ``qualified`` bit."""
        if self.supervisor is None:
            return True
        return self.supervisor.consecutive_skips == 0

    def note_ckpt_failure(self, step: int, path: str, error) -> None:
        """``durable.AsyncCheckpointer``'s ``on_failure`` hook: a failed
        write goes to the supervisor (or the bus). Across processes the
        writer, and so this hook, runs on rank 0 alone; a restore takes
        rank 0's registration to every rank (``_execute_restore``)."""
        if self.supervisor is not None:
            self.supervisor.note_ckpt_write_failure(step, path, error)
        elif self.bus is not None:
            self.bus.emit("ckpt_verify_failed", step=int(step), path=path,
                          reason=f"write_failed: {error}")

    def supervisor_extra(self):
        """A checkpoint's ``extra`` payload: the supervisor's strikes,
        fallbacks and last-good marker (None without resilience)."""
        if self.supervisor is None:
            return None
        return {"supervisor": self.supervisor.to_state()}

    def restore_supervisor(self, ckpt_dir_or_file: str) -> None:
        """Re-arm the supervisor from a checkpoint's ``extra`` payload
        (either package's) and re-apply its dense fallbacks."""
        if self.supervisor is None:
            return
        from oktopk_tpu_torch.train.checkpoint import load_extra
        extra = load_extra(ckpt_dir_or_file) or {}
        self.supervisor.load_state(extra.get("supervisor") or {})
        if self.supervisor.forced_dense:
            self._replan()

    def _agree(self, stop: bool) -> bool:
        """``stop`` of any process (across processes; else as given)."""
        if not self.distributed:
            return bool(stop)
        flag = torch.full((1, 1), int(bool(stop)), dtype=torch.int32,
                          device=self.device)
        return int(self.comm.psum(flag)[0, 0]) > 0

    # ---- the train state ----------------------------------------------

    def train_state(self, host: bool = False, gather: bool = True) -> dict:
        """The JAX ``DistTrainState`` state dict of this Trainer
        (``convert.train_state_to_jax``); a collective across processes
        unless ``gather`` is False."""
        return train_state_to_jax(self, host=host, gather=gather)

    def load_train_state(self, tree: dict, parts=None) -> None:
        """Take a ``DistTrainState`` state dict (e.g. a restored
        checkpoint's ``state``), in place."""
        kw = {} if parts is None else {"parts": parts}
        load_train_state_from_jax(self, tree, **kw)

    # ---- eval ---------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, batch) -> Dict[str, torch.Tensor]:
        """Forward-only loss and accuracy on a whole batch, the model in
        eval mode (no dropout, BatchNorm's running statistics), as the
        JAX Trainer's ``eval_step``: images give ``loss`` and
        ``accuracy``; the PTB LSTM ``loss`` and ``ppl``; BERT the
        pretraining ``loss``, ``mlm_loss`` and ``nsp_loss``; DeepSpeech
        the CTC ``loss`` and the greedy-decoded ``wer`` and ``cer``,
        averaged over the batch (the argmax on the device, the decoding
        on the host; the hypotheses are kept in ``last_hypotheses``)."""
        keys = BATCH_KEYS[self.workload]
        b = {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
             for k in keys}
        m = self.model
        if self.workload == "lm":
            loss = losses.lm_cross_entropy(m(b["tokens"], train=False),
                                           b["targets"])
            return {"loss": loss, "ppl": torch.exp(loss)}
        if self.workload == "bert":
            mlm, nsp = m(b["input_ids"], b["token_type_ids"],
                         b["attention_mask"], train=False)
            loss, aux = losses.bert_pretrain_loss(mlm, nsp, b["mlm_labels"],
                                                  b["nsp_labels"])
            return {"loss": loss, **aux}
        if self.workload == "ctc":
            from oktopk_tpu_torch.data.audio import AN4_LABELS
            from oktopk_tpu_torch.utils.decoder import GreedyDecoder

            logits = m(b["spect"], train=False)
            frames = torch.clamp(ctc_frame_len(b["spect_lengths"]),
                                 max=logits.shape[1])
            loss = losses.ctc_loss(logits, frames, b["labels"],
                                   b["label_lengths"])
            dec = GreedyDecoder(AN4_LABELS)
            hyps = dec.decode_ids(torch.argmax(logits, -1).cpu().numpy(),
                                  frames.cpu().numpy())
            labs = np.asarray(batch["labels"])
            lens = np.asarray(batch["label_lengths"])
            refs = ["".join(AN4_LABELS[c] for c in labs[i, :lens[i]])
                    for i in range(labs.shape[0])]
            self.last_hypotheses = hyps
            wer = float(np.mean([dec.wer(h, r) for h, r in zip(hyps, refs)]))
            cer = float(np.mean([dec.cer(h, r) for h, r in zip(hyps, refs)]))
            return {"loss": loss, "wer": torch.tensor(wer),
                    "cer": torch.tensor(cer)}
        logits = m(b["image"], train=False)
        loss = losses.softmax_cross_entropy(logits, b["label"])
        acc = torch.mean((torch.argmax(logits, -1) == b["label"]).to(
            torch.float32))
        return {"loss": loss, "accuracy": acc}
