"""CIFAR ResNets: resnet20/56/110 (basic blocks, widths 16/32/64,
(depth - 2) / 6 blocks a stage).

Counterpart of ``oktopk_tpu/models/resnet.py``, module for module, with
the flax names (``models/layout.py``): the stem ``Conv_0`` and
``BatchNorm_0``, ``BasicBlock_0..`` numbered across the stages, the head
``Dense_0``; inside a block the two 3x3s are ``Conv_0`` and ``Conv_1``
and the projection shortcut, created after them, ``Conv_2`` (with
``BatchNorm_2``). Convolutions are bias-free. Input NHWC, as the JAX
model takes it; NCHW inside; the head reads the spatial mean.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(cin, filters, 3, strides, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(filters)
        # flax compares shapes; with even sizes that is this test
        self.project = cin != filters or strides != 1
        if self.project:
            self.Conv_2 = Conv2d(cin, filters, 1, strides, bias=False)
            self.BatchNorm_2 = BatchNorm(filters)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        bn = dict(train=train, update_stats=update_stats)
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), **bn))
        y = self.BatchNorm_1(self.Conv_1(y), **bn)
        if self.project:
            x = self.BatchNorm_2(self.Conv_2(x), **bn)
        return F.relu(y + x)


class CifarResNet(FlaxNamedModule):
    """images NHWC [B, 32, 32, 3] -> logits [B, num_classes]."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"depth {depth} is not 6n + 2")
        n = (depth - 2) // 6
        self.Conv_0 = Conv2d(3, 16, 3, 1, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(16)
        self.num_blocks, c = 3 * n, 16
        for stage, filters in enumerate((16, 32, 64)):
            for block in range(n):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"BasicBlock_{stage * n + block}",
                                BasicBlock(c, filters, strides))
                c = filters
        self.Dense_0 = Linear(c, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train, update_stats))
        for i in range(self.num_blocks):
            x = self.get_submodule(f"BasicBlock_{i}")(x, train, update_stats)
        return self.Dense_0(x.mean((2, 3))).to(torch.float32)
