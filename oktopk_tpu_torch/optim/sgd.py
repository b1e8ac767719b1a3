"""SGD with weight decay, momentum and nesterov.

Counterpart of ``oktopk_tpu/optim/sgd.py:29-61`` (the reference's custom
``_step``):

    d_p = grad + weight_decay * p
    buf = momentum * buf + d_p                  (dampening = 0)
    d_p = d_p + momentum * buf   if nesterov else buf
    p  += -lr * d_p

Parameters are updated in place (the JAX form returns new arrays).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class SGD:
    def __init__(self, lr: float, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False):
        self.lr = float(lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.momentum_buf: List[torch.Tensor] | None = None

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.momentum_buf = ([torch.zeros_like(p) for p in params]
                             if self.momentum else None)

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor]) -> None:
        """Apply one step to ``params`` in place."""
        wd, m = self.weight_decay, self.momentum
        for i, (p, g) in enumerate(zip(params, grads)):
            if wd:
                g = g + wd * p
            if m:
                buf = self.momentum_buf[i]
                buf.copy_(m * buf + g)
                d = g + m * buf if self.nesterov else buf
            else:
                d = g
            p.add_(-self.lr * d)
