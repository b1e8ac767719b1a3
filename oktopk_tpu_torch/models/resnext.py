"""ResNeXt for CIFAR: bottleneck blocks whose 3x3 is grouped
(``groups = cardinality``), resnext29 (8 x 64d) by default.

Counterpart of ``oktopk_tpu/models/resnext.py``, with the flax names
(``models/layout.py``): ``Conv_0``, ``BatchNorm_0``, ``ResNeXtBlock_0..``,
``Dense_0``; inside a block the 1x1, the grouped 3x3 and the expanding
1x1 are ``Conv_0..2``, the projection shortcut ``Conv_3`` (with
``BatchNorm_3``). A grouped kernel is flax's HWIO with I = width /
groups, PyTorch's [width, width / groups, 3, 3]: the same OIHW <-> HWIO
permutation. Input NHWC, NCHW inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class ResNeXtBlock(nn.Module):
    def __init__(self, cin: int, filters: int, cardinality: int = 8,
                 base_width: int = 64, strides: int = 1):
        super().__init__()
        width = cardinality * base_width * filters // 256
        self.Conv_0 = Conv2d(cin, width, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(width)
        self.Conv_1 = Conv2d(width, width, 3, strides, 1,
                                groups=cardinality, bias=False)
        self.BatchNorm_1 = BatchNorm(width)
        self.Conv_2 = Conv2d(width, filters, 1, bias=False)
        self.BatchNorm_2 = BatchNorm(filters)
        self.project = cin != filters or strides != 1
        if self.project:
            self.Conv_3 = Conv2d(cin, filters, 1, strides, bias=False)
            self.BatchNorm_3 = BatchNorm(filters)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        bn = dict(train=train, update_stats=update_stats)
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), **bn))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), **bn))
        y = self.BatchNorm_2(self.Conv_2(y), **bn)
        if self.project:
            x = self.BatchNorm_3(self.Conv_3(x), **bn)
        return F.relu(y + x)


class ResNeXt(FlaxNamedModule):
    """images NHWC [B, 32, 32, 3] -> logits [B, num_classes]."""

    def __init__(self, depth: int = 29, cardinality: int = 8,
                 base_width: int = 64, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (depth - 2) % 9:
            raise ValueError(f"depth {depth} is not 9n + 2")
        n = (depth - 2) // 9
        self.Conv_0 = Conv2d(3, 64, 3, 1, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        self.num_blocks, c = 3 * n, 64
        for stage, filters in enumerate((256, 512, 1024)):
            for block in range(n):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(
                    f"ResNeXtBlock_{stage * n + block}",
                    ResNeXtBlock(c, filters, cardinality, base_width,
                                 strides))
                c = filters
        self.Dense_0 = Linear(c, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train, update_stats))
        for i in range(self.num_blocks):
            x = self.get_submodule(f"ResNeXtBlock_{i}")(x, train,
                                                        update_stats)
        return self.Dense_0(x.mean((2, 3))).to(torch.float32)
