"""ImageNet ResNet-50: a strided 7x7 stem, a 3x3 stride-2 max pool, four
stages of bottleneck blocks (3, 4, 6, 3 by default), the spatial mean and
a 1000-way head.

Counterpart of ``oktopk_tpu/models/imagenet_resnet.py``, module for
module, with the flax names (``models/layout.py``): ``Conv_0``,
``BatchNorm_0``, ``Bottleneck_0..`` numbered across the stages,
``Dense_0``; inside a block the 1x1, the strided 3x3 and the expanding
1x1 are ``Conv_0..2``, the projection shortcut, created after them,
``Conv_3`` (with ``BatchNorm_3``). flax's 1x1 convolutions take 'SAME'
padding, which pads nothing for a 1x1 kernel at any stride; the stem
pool's ((1, 1), (1, 1)) is PyTorch's padding 1, padded with -inf as
flax's ``max_pool`` pads. Input NHWC, NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        out = 4 * filters
        self.Conv_0 = Conv2d(cin, filters, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv2d(filters, filters, 3, strides, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv2d(filters, out, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(out)
        self.project = cin != out or strides != 1
        if self.project:
            self.Conv_3 = Conv2d(cin, out, 1, strides, bias=False)
            self.BatchNorm_3 = BatchNorm(out)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        bn = dict(train=train, update_stats=update_stats)
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), **bn))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), **bn))
        y = self.BatchNorm_2(self.Conv_2(y), **bn)
        if self.project:
            x = self.BatchNorm_3(self.Conv_3(x), **bn)
        return F.relu(y + x)


class ResNet50(FlaxNamedModule):
    """images NHWC [B, H, W, 3] (224 x 224 on ImageNet) -> logits
    [B, num_classes]."""

    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        c, i = 64, 0
        for stage, nblocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            for block in range(nblocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"Bottleneck_{i}",
                                Bottleneck(c, filters, strides))
                c, i = 4 * filters, i + 1
        self.num_blocks = i
        self.Dense_0 = Linear(c, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train, update_stats))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i in range(self.num_blocks):
            x = self.get_submodule(f"Bottleneck_{i}")(x, train, update_stats)
        return self.Dense_0(x.mean((2, 3))).to(torch.float32)
