"""Caffe's cifar10_quick net: three 5x5 conv-pool stages and two dense
layers.

Counterpart of ``oktopk_tpu/models/caffe_cifar.py``, with the flax names
(``models/layout.py``): ``Conv_0..2`` (with biases) and ``Dense_0..1``.
It pools with flax's asymmetric padding ((0, 1), (0, 1)). PyTorch's
pools pad symmetrically, so the map is padded on the bottom and right
first (``pad_bottom_right``), with -inf before the max pool (as flax pads
it) and with zeros before the average pools, which count them (flax's
``avg_pool`` divides by the full 3 x 3 window), then pooled unpadded.
The head flattens NHWC. Input NHWC, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (Conv2d, Linear, flatten_nhwc,
                                            pad_bottom_right,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class CaffeCifar(FlaxNamedModule):
    """images NHWC [B, 32, 32, 3] -> logits [B, num_classes]."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(3, 32, 5, 1, 2)
        self.Conv_1 = Conv2d(32, 32, 5, 1, 2)
        self.Conv_2 = Conv2d(32, 64, 5, 1, 2)
        self.Dense_0 = Linear(64 * 4 * 4, 64)
        self.Dense_1 = Linear(64, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = self.Conv_0(x_nhwc.permute(0, 3, 1, 2))
        x = F.relu(F.max_pool2d(pad_bottom_right(x, float("-inf")), 3, 2))
        x = F.relu(self.Conv_1(x))
        x = F.avg_pool2d(pad_bottom_right(x, 0.0), 3, 2)
        x = F.relu(self.Conv_2(x))
        x = F.avg_pool2d(pad_bottom_right(x, 0.0), 3, 2)
        x = self.Dense_0(flatten_nhwc(x))
        return self.Dense_1(x).to(torch.float32)
