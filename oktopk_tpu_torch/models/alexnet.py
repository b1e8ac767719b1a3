"""AlexNet, the CIFAR-sized variant of the reference's harness.

Counterpart of ``oktopk_tpu/models/alexnet.py``, with the flax names
(``models/layout.py``): ``Conv_0..4`` (with biases, flax's default) and
``Dense_0``. The head flattens NHWC, as the flax model does. Input NHWC,
NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (Conv2d, Linear, flatten_nhwc,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class AlexNet(FlaxNamedModule):
    """images NHWC [B, 32, 32, 3] -> logits [B, num_classes]."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(3, 64, 3, 2, 1)
        self.Conv_1 = Conv2d(64, 192, 3, 1, 1)
        self.Conv_2 = Conv2d(192, 384, 3, 1, 1)
        self.Conv_3 = Conv2d(384, 256, 3, 1, 1)
        self.Conv_4 = Conv2d(256, 256, 3, 1, 1)
        # 32 -> 16 (stride 2) -> 2 after three pools
        self.Dense_0 = Linear(256 * 2 * 2, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = F.max_pool2d(F.relu(self.Conv_4(x)), 2, 2)
        return self.Dense_0(flatten_nhwc(x)).to(torch.float32)
