"""The small MNIST CNN: two 5x5 conv-pool stages, a 512-wide dense layer
and the head.

Counterpart of ``oktopk_tpu/models/mnistnet.py``, with the flax names
(``models/layout.py``): ``Conv_0..1`` (with biases) and ``Dense_0..1``.
The head flattens NHWC. Input NHWC [B, 28, 28, 1], NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (Conv2d, Linear, flatten_nhwc,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class MnistNet(FlaxNamedModule):
    """images NHWC [B, 28, 28, 1] -> logits [B, num_classes]."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(1, 32, 5, 1, 2)
        self.Conv_1 = Conv2d(32, 64, 5, 1, 2)
        self.Dense_0 = Linear(64 * 7 * 7, 512)
        self.Dense_1 = Linear(512, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x).to(torch.float32)
