"""A minimal data-parallel trainer: P workers stacked on one device, or
one worker per process.

Counterpart of the parts of ``oktopk_tpu/train/trainer.py`` and
``optim/distributed.py::build_sparse_grad_step`` that the port runs
(init, ``train_step``, ``train`` with ``should_stop`` and ``last_step``
(:635-671), ``eval_step`` (:874-919), the step options
``nsteps_update``, ``grad_clip``, momentum correction and
``profile_norm``, the workload dispatch of :44-53, :98-107, :558-624
for the CNN zoo, BERT pretraining, the PTB LSTM and DeepSpeech on AN4,
and the run journal with its quality taps, below). Not ported yet
(ROADMAP.md): the anomaly guard and its supervisor, fault plans, the
autotuner and its feedback loop, step anatomy and anomaly tracing.

With ``cfg.obs`` the Trainer runs the JAX Trainer's run journal
(:121-170, less the anomaly tracer): an ``EventBus`` and a
``RunJournal`` (``cfg.obs_journal``, in memory when None), then, with
``cfg.obs_quality``, the step's quality taps (``SparseGradStep``'s
rings) and a ``RollupEngine`` built after the journal, so each
``quality_rollup`` lands directly after its ``quality`` event; with
``cfg.obs_regress_key`` a ``RegressionDetector``. ``train`` journals a
``step`` event per step on the log cadence from a pending list (one
device-to-host copy a flush, no per-step sync), a ``phase`` event from
its ``PhaseTimers``, the quality flush every ``cfg.obs_quality_every``
steps (``_flush_quality``: one copy of the rings to the host), and at
the end the tail flush and one ``volume_report`` per bucket.

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
"""

from __future__ import annotations

import logging
import math
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
from oktopk_tpu_torch.obs.journal import EventBus, RunJournal
from oktopk_tpu_torch.obs.metrics_buffer import rows_since
from oktopk_tpu_torch.obs.quality import QualityConfig, quality_event
from oktopk_tpu_torch.obs.regress import RegressionDetector
from oktopk_tpu_torch.obs.rollup import RollupEngine
from oktopk_tpu_torch.ops import prng
from oktopk_tpu_torch.optim import SGD, BertAdam
from oktopk_tpu_torch.optim.distributed import SparseGradStep, flat_size
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
                 profile_norm: bool = False, comm=None):
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
            if cfg.obs_regress_key:
                self.regress = RegressionDetector.from_bench_records(
                    key=cfg.obs_regress_key, bus=self.bus,
                    tolerance=cfg.obs_regress_tolerance,
                    phase_limits=cfg.obs_phase_limits)
        self.grad_step = SparseGradStep(
            self.algo_cfg, self.comm, self.params, cfg.compressor,
            cfg.num_buckets, warmup=warmup, device=self.device,
            momentum_correction=mc, profile_norm=profile_norm,
            quality=self._quality_cfg)
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
        pair = prng.split(self._rng)
        self._rng = pair[0]
        mb_keys = self.microbatch_keys(pair[1])
        worker = []
        for i in range(W):
            for p in self.params:
                p.grad = None
            sums = {}
            for j in range(ns):      # autograd adds the microbatch grads
                rows = slice((i * ns + j) * b, (i * ns + j + 1) * b)
                loss, aux = self._loss({k: v[rows] for k, v in data.items()},
                                       first + i, mb_keys[i, j])
                loss.backward()
                for k, v in {"loss": loss, **aux}.items():
                    sums[k] = sums.get(k, 0.0) + v.detach()
            self._write_flat_grad(i)
            worker.append({k: v / ns for k, v in sums.items()})
        if ns > 1:
            self.flat.div_(ns)
        if self.cfg.grad_clip is not None:
            norm = torch.sqrt(torch.sum(self.flat * self.flat, 1,
                                        keepdim=True))
            self.flat.mul_(torch.clamp(self.cfg.grad_clip / (norm + 1e-12),
                                       max=1.0))
        reduced, metrics = self.grad_step(self.flat)
        self._apply_update(reduced)
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
            host = torch.stack([torch.stack([m[k].to(torch.float64)
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
            if trace is not None:
                trace.on_step(step)
            if timers is not None:
                with timers.phase("data"):
                    batch = next(data_iter)
                with timers.phase("step"):
                    metrics = self.train_step(batch)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            else:
                metrics = self.train_step(next(data_iter))
            if (self._quality_cfg is not None
                    and step % self._quality_cfg.every == 0):
                # the rings are drained on their own cadence only
                self._flush_quality(step)
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
        if self._quality_cfg is not None:
            # the tail of the run, a partial window
            self._flush_quality(self.last_step)
        if self.bus is not None:
            self._emit_volume_report()
        return {k: float(v) for k, v in metrics.items()}

    # ---- the run journal ------------------------------------------------

    def _bucket_plan(self):
        """Per-bucket (algo name, density) names for the reports (the
        JAX Trainer's, :755; the port has no autotune plans or dense
        fallbacks yet, so every bucket runs ``cfg.compressor`` at
        ``cfg.density``)."""
        nb = max(1, self.cfg.num_buckets)
        return [self.cfg.compressor] * nb, [self.cfg.density] * nb

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
        """The rollup engine's breach hook (the JAX Trainer's, :316). JAX
        routes fidelity breaches to its density-backoff controller
        (``resilience/density.py``), which comes with ROADMAP item 17b;
        without one it returns, as JAX's does with resilience off. The
        breach stays in the journal, in the rollup's ``breaches``."""
        return None

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
