"""Pre-activation ResNet for CIFAR: BN-ReLU-Conv ordering, preresnet110
by default.

Counterpart of ``oktopk_tpu/models/preresnet.py``, with the flax names
(``models/layout.py``): ``Conv_0``, ``PreActBlock_0..``, the final
``BatchNorm_0`` and ``Dense_0``. A block creates its projection shortcut
(a 1x1 on the pre-activated input) before its 3x3s, so where it has one
the shortcut is ``Conv_0`` and the 3x3s ``Conv_1`` and ``Conv_2``;
elsewhere the 3x3s are ``Conv_0`` and ``Conv_1``. Input NHWC, NCHW
inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class PreActBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin)
        self.project = cin != filters or strides != 1
        i = 0
        if self.project:
            self.Conv_0 = Conv2d(cin, filters, 1, strides, bias=False)
            i = 1
        self.add_module(f"Conv_{i}", Conv2d(cin, filters, 3, strides, 1,
                                               bias=False))
        self.BatchNorm_1 = BatchNorm(filters)
        self.add_module(f"Conv_{i + 1}", Conv2d(filters, filters, 3, 1,
                                                   1, bias=False))
        self.first = i

    def forward(self, x, train: bool = True, update_stats: bool = True):
        bn = dict(train=train, update_stats=update_stats)
        y = F.relu(self.BatchNorm_0(x, **bn))
        shortcut = self.Conv_0(y) if self.project else x
        y = self.get_submodule(f"Conv_{self.first}")(y)
        y = F.relu(self.BatchNorm_1(y, **bn))
        y = self.get_submodule(f"Conv_{self.first + 1}")(y)
        return shortcut + y


class PreResNet(FlaxNamedModule):
    """images NHWC [B, 32, 32, 3] -> logits [B, num_classes]."""

    def __init__(self, depth: int = 110, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"depth {depth} is not 6n + 2")
        n = (depth - 2) // 6
        self.Conv_0 = Conv2d(3, 16, 3, 1, 1, bias=False)
        self.num_blocks, c = 3 * n, 16
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"PreActBlock_{stage * n + block}",
                                PreActBlock(c, filters, strides))
                c = filters
        self.BatchNorm_0 = BatchNorm(c)
        self.Dense_0 = Linear(c, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = self.Conv_0(x_nhwc.permute(0, 3, 1, 2))
        for i in range(self.num_blocks):
            x = self.get_submodule(f"PreActBlock_{i}")(x, train,
                                                       update_stats)
        x = F.relu(self.BatchNorm_0(x, train, update_stats))
        return self.Dense_0(x.mean((2, 3))).to(torch.float32)
