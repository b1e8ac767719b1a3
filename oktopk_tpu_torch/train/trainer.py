"""A minimal data-parallel trainer: P workers stacked on one device, or
one worker per process.

Counterpart of the parts of ``oktopk_tpu/train/trainer.py`` and
``optim/distributed.py::build_sparse_grad_step`` that the port runs
(init, ``train_step``, ``train`` with ``should_stop`` and ``last_step``
(:635-671), ``eval_step`` (:874-919), the step options
``nsteps_update``, ``grad_clip``, momentum correction and
``profile_norm``, and the workload dispatch of :44-53, :98-107, :558-624
for the CNN zoo, BERT pretraining, the PTB LSTM and DeepSpeech on AN4);
the obs, resilience and autotune planes are not ported yet (ROADMAP.md).

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
        self.grad_step = SparseGradStep(
            self.algo_cfg, self.comm, self.params, cfg.compressor,
            cfg.num_buckets, warmup=warmup, device=self.device,
            momentum_correction=mc, profile_norm=profile_norm)
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
              logger: Optional[logging.Logger] = None,
              start_step: int = 0, should_stop=None) -> Dict[str, float]:
        """Run ``num_iters`` steps; returns the last step's metrics on the
        host (empty when no step ran). ``should_stop`` is polled before
        each step, and a True stops the loop between steps (the JAX
        Trainer's preemption hook); across processes the ranks agree on
        it (one small psum a step), so all stop at the same step.
        ``last_step`` is the last step run."""
        metrics = {}
        t0 = time.time()
        self.last_step = start_step
        for i in range(num_iters):
            if should_stop is not None and self._agree(should_stop()):
                break
            step = start_step + i + 1
            self.last_step = step
            metrics = self.train_step(next(data_iter))
            if (i + 1) % log_every == 0 and logger is not None:
                dt = (time.time() - t0) / log_every
                logger.info("iter %d loss %.4f vol %.0f %.3fs/it", step,
                            float(metrics["loss"]),
                            float(metrics["comm_volume"]), dt)
                t0 = time.time()
        return {k: float(v) for k, v in metrics.items()}

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
