"""A minimal data-parallel trainer: P workers stacked on one device.

Counterpart of the parts of ``oktopk_tpu/train/trainer.py`` and
``optim/distributed.py::build_sparse_grad_step`` that the VGG-16 slice
runs (init, ``train_step``, ``train``); the obs, resilience and autotune
planes are not ported yet (ROADMAP.md).

One step:
1. each of the P workers runs forward/backward on its shard of the global
   batch (shard p = rows [p*b, (p+1)*b), as the JAX step shards it);
2. its gradient is written into row p of a flat [P, n] buffer in the JAX
   package's leaf order and layout (``VGG.jax_leaves``) — one n-scale
   copy per worker — so buckets, regions and selections match the
   reference's;
3. the sparse collective (``optim/distributed.py``) reduces it;
4. SGD updates the (single, replicated) parameters from the result.

BatchNorm running statistics come from worker 0's shard, as the JAX step
returns them (``out_specs=P()`` takes shard 0). The reported loss is the
mean of the P worker losses, added in rank order.

On the card TF32 is switched off for cuDNN convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` set False, process-wide), so
the float32 model computes in float32 as the reference does.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, Iterable, Optional

import torch

from oktopk_tpu_torch import resolve_device
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
from oktopk_tpu_torch.convert import from_jax_params
from oktopk_tpu_torch.models import create_model
from oktopk_tpu_torch.models.vgg import from_jax_layout, to_jax_layout
from oktopk_tpu_torch.optim import SGD
from oktopk_tpu_torch.optim.distributed import SparseGradStep, flat_size
from oktopk_tpu_torch.train import losses


def _lecun_normal_(p: torch.Tensor, fan_in: int, gen: torch.Generator):
    with torch.no_grad():
        w = torch.randn(p.shape, generator=gen) * math.sqrt(1.0 / fan_in)
        p.copy_(w)


class Trainer:
    """Data-parallel SGD over ``cfg.num_workers`` workers stacked on one
    device, every gradient through ``cfg.compressor``."""

    def __init__(self, cfg: TrainConfig,
                 algo_cfg: Optional[OkTopkConfig] = None, device=None,
                 warmup: bool = True,
                 model_kwargs: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        P = cfg.num_workers
        self.comm = StackedComm(P)
        model = create_model(cfg.dnn, **(model_kwargs or {}))
        gen = torch.Generator().manual_seed(cfg.seed)
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
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
        self.optimizer = SGD(cfg.lr, momentum=cfg.momentum,
                             weight_decay=cfg.weight_decay,
                             nesterov=cfg.nesterov)
        self.optimizer.init(self.params)
        self.grad_step = SparseGradStep(
            self.algo_cfg, self.comm, self.params, cfg.compressor,
            cfg.num_buckets, warmup=warmup, device=self.device)
        self.flat = torch.empty((P, n), dtype=torch.float32,
                                device=self.device)

    def load_jax_variables(self, params_np, batch_stats_np=None) -> None:
        """Take the flax model's weights (``convert.from_jax_params``)."""
        sd = from_jax_params(params_np, batch_stats_np)
        self.model.load_state_dict(sd, strict=batch_stats_np is not None)

    def _write_flat_grad(self, w: int) -> None:
        row = self.flat[w]
        for (_, p, lay), shp, s, e in zip(self.leaves, self.jax_shapes,
                                          self.offsets[:-1],
                                          self.offsets[1:]):
            row[s:e].view(shp).copy_(to_jax_layout(p.grad, lay))

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One data-parallel step on a global batch (dict of arrays with a
        leading [P * b] dimension). Metrics stay on the device."""
        P = self.comm.size
        dev = self.device
        images = torch.as_tensor(batch["image"]).to(dev)
        labels = torch.as_tensor(batch["label"]).to(dev)
        b = images.shape[0] // P
        if b * P != images.shape[0]:
            raise ValueError(f"global batch {images.shape[0]} is not a "
                             f"multiple of {P} workers")
        worker_losses = []
        for w in range(P):
            for p in self.params:
                p.grad = None
            logits = self.model(images[w * b:(w + 1) * b], train=True,
                                update_stats=(w == 0))
            loss = losses.softmax_cross_entropy(logits,
                                                labels[w * b:(w + 1) * b])
            loss.backward()
            self._write_flat_grad(w)
            worker_losses.append(loss.detach())
        reduced, metrics = self.grad_step(self.flat)
        grads = [from_jax_layout(reduced[s:e].view(shp), lay)
                 for (_, _, lay), shp, s, e in zip(
                     self.leaves, self.jax_shapes, self.offsets[:-1],
                     self.offsets[1:])]
        self.optimizer.update(self.params, grads)
        for p in self.params:
            p.grad = None
        total = worker_losses[0]
        for lw in worker_losses[1:]:
            total = total + lw
        return {"loss": total / P, **metrics}

    def train(self, data_iter: Iterable, num_iters: int, log_every: int = 50,
              logger: Optional[logging.Logger] = None,
              start_step: int = 0) -> Dict[str, float]:
        """Run ``num_iters`` steps; returns the last step's metrics on the
        host."""
        metrics = {}
        t0 = time.time()
        for i in range(num_iters):
            step = start_step + i + 1
            metrics = self.train_step(next(data_iter))
            if (i + 1) % log_every == 0 and logger is not None:
                dt = (time.time() - t0) / log_every
                logger.info("iter %d loss %.4f vol %.0f %.3fs/it", step,
                            float(metrics["loss"]),
                            float(metrics["comm_volume"]), dt)
                t0 = time.time()
        return {k: float(v) for k, v in metrics.items()}
