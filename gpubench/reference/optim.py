"""The optimizers on flat float32 vectors, plain PyTorch.

SGD (the Ok-Topk reference's ``VGG/`` step): d = g + wd * p;
buf = momentum * buf + d; p -= lr * buf.

BertAdam (the BERT reference's optimizer, Adam without bias correction):
g is clipped to global norm ``max_grad_norm``; m = b1 m + (1 - b1) g;
v = b2 v + (1 - b2) g^2; p += -lr_t (m / (sqrt(v) + eps) + wd p), with
lr_t = lr * warmup_linear(step / t_total): x / warmup while x < warmup,
else max(0, 1 - x).
"""

from __future__ import annotations

from typing import Dict

import torch


class SGD:
    def __init__(self, lr: float, momentum: float, weight_decay: float):
        self.lr, self.momentum, self.wd = lr, momentum, weight_decay
        self.buf = None

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        d = g + self.wd * p
        self.buf = d if self.buf is None else self.momentum * self.buf + d
        return p - self.lr * self.buf

    def state(self) -> torch.Tensor:
        """The state the first step leaves: the momentum buffer."""
        return self.buf


class BertAdam:
    def __init__(self, lr: float, warmup: float, t_total: int, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 max_grad_norm: float):
        self.lr, self.warmup, self.t_total = lr, warmup, t_total
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.m = self.v = None
        self.t = 0

    def lr_t(self) -> float:
        if self.t_total <= 0:
            return self.lr
        x = self.t / self.t_total
        s = x / self.warmup if x < self.warmup else max(0.0, 1.0 - x)
        return self.lr * s

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.max_norm > 0:
            g = g * torch.clamp(self.max_norm / (g.norm() + 1e-12), max=1.0)
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        u = self.m / (torch.sqrt(self.v) + self.eps) + self.wd * p
        out = p - self.lr_t() * u
        self.t += 1
        return out

    def state(self) -> torch.Tensor:
        """The state the first step leaves: the first moment."""
        return self.m


def received_gradient(spec: Dict, state: torch.Tensor,
                      p0: torch.Tensor) -> torch.Tensor:
    """The gradient the optimizer received in its first step, worked out
    from the state that step left (``state()``) and the parameters before
    it: SGD's buffer less the weight decay, BertAdam's first moment over
    1 - b1 (the gradient after its clip)."""
    if spec["optimizer"] == "sgd":
        return state - spec["weight_decay"] * p0
    return state / (1 - spec["b1"])


def build(spec: Dict):
    """An optimizer from a configuration's ``training`` section."""
    kind = spec["optimizer"]
    if kind == "sgd":
        return SGD(spec["lr"], spec["momentum"], spec["weight_decay"])
    if kind == "bert_adam":
        return BertAdam(spec["lr"], spec["warmup_proportion"],
                        spec["total_steps"], spec["b1"], spec["b2"],
                        spec["eps"], spec["weight_decay"],
                        spec["max_grad_norm"])
    raise ValueError(f"no reference optimizer {kind!r}")
