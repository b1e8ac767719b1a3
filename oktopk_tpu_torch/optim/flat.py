"""One optimizer over a flat gradient: a worker's flat parameter copy, or
a bucket's parameters seen through the bucket's flat layout.

``BertAdam`` keeps flat [n] moments and clips by the norm of the flat
gradient it is given, so each flat vector (a worker copy, a pipeline
bucket, a tensor-parallel shard) is clipped by its own norm. ``SGD``
keeps one momentum buffer a parameter and steps the parameters in
place.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence, Union

import torch

from oktopk_tpu_torch.optim.bert_adam import BertAdam

Params = Union[torch.Tensor, Sequence[torch.Tensor]]


def _as_list(params: Params) -> List[torch.Tensor]:
    return [params] if isinstance(params, torch.Tensor) else list(params)


def init_opt(optimizer, params: Params):
    """A copy of ``optimizer`` initialised on ``params``: one flat [n]
    tensor, or a bucket's parameters."""
    params = _as_list(params)
    opt = copy.deepcopy(optimizer)
    if isinstance(opt, BertAdam):
        opt.init(sum(p.numel() for p in params), params[0].device)
    else:
        opt.init(params)
    return opt


@torch.no_grad()
def apply_opt(opt, params: Params, grad: torch.Tensor,
              views: Optional[Callable] = None,
              flat: Optional[Callable] = None,
              gnorm: Optional[torch.Tensor] = None) -> None:
    """One step of ``opt`` on ``params`` in place, from the flat gradient
    ``grad`` [n]. ``params`` is one flat [n] tensor, or a bucket's
    parameters with ``views`` (a flat [n] -> one tensor a parameter) and
    ``flat`` (one tensor a parameter -> the flat [n]). ``gnorm``: the
    norm ``BertAdam`` clips by, when it spans more than ``grad``."""
    params = _as_list(params)
    if views is None:
        views, flat = (lambda x: [x]), (lambda ts: ts[0])
    if isinstance(opt, BertAdam):
        for p, u in zip(params, views(opt.update(grad, flat(params),
                                                 gnorm=gnorm))):
            p.add_(u)
    else:
        opt.update(params, views(grad))
