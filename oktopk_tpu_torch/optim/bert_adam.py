"""BertAdam: Adam without bias correction, a warmup schedule and a
global-norm gradient clip.

Counterpart of ``oktopk_tpu/optim/bert_adam.py:33-81``:

    g = g * min(1, max_grad_norm / (||g|| + 1e-12))   (max_grad_norm > 0)
    m = b1*m + (1-b1)*g ;  v = b2*v + (1-b2)*g*g
    update = -lr_t * (m / (sqrt(v) + eps) + weight_decay * p)
    lr_t = lr * schedule(step / t_total, warmup)   if t_total > 0, else lr

There is no bias correction (BertAdam's quirk). It works on flat [n]
float32 buffers in the JAX leaf order (the trainer's reduced gradient
and a flat copy of the parameters), so m and v are one buffer each; the
JAX form sums the global norm leaf by leaf, this one over the flat
buffer, which differs in the last bits. ``step`` is an int32 counter on
the device, and the learning rate is computed there, so no update waits
for the host.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.optim.schedules import SCHEDULES


class BertAdam:
    def __init__(self, lr: float = 2e-4, warmup: float = 0.01,
                 t_total: int = -1, schedule: str = "warmup_linear",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        self.lr, self.warmup, self.t_total = lr, warmup, t_total
        self.schedule_fn = SCHEDULES[schedule]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.step = self.m = self.v = None

    def init(self, n: int, device) -> None:
        """Zero moments for ``n`` parameters and a step counter of 0."""
        self.step = torch.zeros((), dtype=torch.int32, device=device)
        self.m = torch.zeros((n,), dtype=torch.float32, device=device)
        self.v = torch.zeros((n,), dtype=torch.float32, device=device)

    def lr_t(self) -> torch.Tensor:
        """The learning rate of the next update (float32, 0-d)."""
        if self.t_total > 0:
            x = self.step.to(torch.float32) / self.t_total
            return self.lr * self.schedule_fn(x, self.warmup)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=self.step.device)

    @torch.no_grad()
    def update(self, grad: torch.Tensor,
               params: torch.Tensor | None = None,
               gnorm: torch.Tensor | None = None) -> torch.Tensor:
        """The additive update for the flat ``params`` [n] from the flat
        ``grad`` [n]; advances m, v and the step. ``gnorm``: the global
        norm to clip by when the tree spans more than ``grad`` (the MoE
        dense step's expert shards across ranks); default ``grad``'s."""
        if self.max_grad_norm > 0:
            if gnorm is None:
                gnorm = torch.sqrt(torch.sum(grad * grad))
            scale = torch.clamp(self.max_grad_norm / (gnorm + 1e-12),
                                max=1.0)
            grad = grad * scale
        b1, b2 = self.b1, self.b2
        self.m = b1 * self.m + (1 - b1) * grad
        self.v = b2 * self.v + (1 - b2) * grad * grad
        lr_t = self.lr_t()
        u = self.m / (torch.sqrt(self.v) + self.eps)
        if self.weight_decay > 0 and params is not None:
            u = u + self.weight_decay * params
        self.step = self.step + 1
        return -lr_t * u
