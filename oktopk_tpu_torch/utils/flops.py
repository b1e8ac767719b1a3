"""Model complexity accounting.

Counterpart of ``oktopk_tpu/utils/flops.py`` (``param_count`` :19,
``model_complexity`` :23; reference C21: the vendored ptflops per-layer
MACs/params hooks, BERT/ptflops/flops_counter.py:19-410, reported at
startup by main_bert.py:861-869). Where JAX reads XLA's cost analysis of
the compiled program, the port counts the operations PyTorch dispatches
for one call under ``torch.utils.flop_counter.FlopCounterMode`` (the
matrix products, convolutions and attention, 2 flops a multiply-add, as
XLA counts them).
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def param_count(params) -> int:
    """Elements of ``params``: a module, or an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return int(sum(p.numel() for p in params))


def model_complexity(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and report its
    flops under JAX's keys: ``flops``, ``bytes_accessed`` and
    ``cost_analysis`` (the counter's flops by operator). PyTorch's counter
    counts no bytes, so ``bytes_accessed`` is -1.0, the JAX function's
    value for a key its cost analysis lacks."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    # "Global" holds every operator once; the per-module entries nest
    by_op = {str(op): float(v) for op, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": -1.0,
            "cost_analysis": by_op}
