"""Model FLOPs per sample, counted on the benchmark's own reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products
and convolutions of one forward pass of the reference model over one
batch on the meta device (shapes only, no data, no dropout); backward is
taken as twice forward and nothing recomputed counts. So the number is
the work the model needs, whatever the program dispatches for it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference import train as ref_train


def forward_flops(config: Dict, workload: Dict, traffic, batch: int) -> int:
    """``traffic``: the cell's generator module, whose ``meta_batch``
    shapes the inputs."""
    fam = ref_train.family(config["family"])
    table = fam.leaf_table(config["model"])
    n = sum(_numel(shape) for _, shape, _ in table)
    flat = torch.empty(n, device=torch.device("meta"))
    inputs = traffic.meta_batch(config, workload, batch)
    with FlopCounterMode(display=False) as counter:
        fam.loss(ref_train.views(flat, table), inputs, config["model"], None,
                 "float32")
    return int(counter.get_total_flops())


def per_sample(config: Dict, workload: Dict, traffic, batch: int = 2
               ) -> float:
    """Forward plus backward (twice forward) FLOPs of one sample."""
    return 3.0 * forward_flops(config, workload, traffic, batch) / batch


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out
