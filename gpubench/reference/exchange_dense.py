"""The dense allreduce over P workers, plain PyTorch: the mean of the
workers' gradients, added in rank order. On the wire a ring allreduce
moves about 2n float32 values a worker, so ``wire_bytes`` is 8n.

An exchange's reference is ``reference/exchange_<compressor>.py``, found
by the cell's ``compressor``: ``context``, ``program_settings``,
``steady``, ``init_state`` and ``allreduce``, as here and in
``exchange_oktopk.py``.
"""

from __future__ import annotations

from typing import Dict

import torch


def context(n: int, workers: int, density: float, config: Dict) -> None:
    """The exchange's settings at this size: none for the dense mean."""
    return None


def program_settings(config: Dict) -> Dict:
    """The program's exchange settings (``trainer.algo_cfg``) that the
    configuration states: none."""
    return {}


def steady(ctx, step: int) -> bool:
    """Whether step ``step`` (from 0) does the steady work: every step."""
    return True


def init_state(ctx, device) -> Dict:
    return {"step": 0}


def allreduce(grad: torch.Tensor, st: Dict, ctx=None):
    """(the mean of ``grad`` [P, n] over workers, the next state, worker
    0's wire bytes)."""
    total = grad[0].clone()
    for w in range(1, grad.shape[0]):
        total = total + grad[w]
    return (total / grad.shape[0], {"step": st["step"] + 1},
            2.0 * grad.shape[1] * 4.0)
