"""DenseNet-BC for CIFAR: three dense blocks of bottleneck layers that
concatenate ``growth_rate`` new channels each, transitions that halve
the channels (``compression``) and average-pool 2x2; densenet100 (k = 12)
by default.

Counterpart of ``oktopk_tpu/models/densenet.py``, with the flax names
(``models/layout.py``): the transitions and the final BatchNorm live in
the top scope beside the layers, so the top scope holds ``Conv_0`` (the
stem), ``DenseLayer_0..`` numbered across the blocks, ``BatchNorm_0``
and ``Conv_1`` (first transition), ``BatchNorm_1`` and ``Conv_2``
(second), ``BatchNorm_2`` (final) and ``Dense_0``. Concatenation on
NCHW's channel axis is flax's on NHWC's last axis. Input NHWC, NCHW
inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule


class DenseLayer(nn.Module):
    """BN-ReLU-1x1 (4k) -BN-ReLU-3x3 (k), concatenated onto the input."""

    def __init__(self, cin: int, growth_rate: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_0 = Conv2d(cin, 4 * growth_rate, 1, bias=False)
        self.BatchNorm_1 = BatchNorm(4 * growth_rate)
        self.Conv_1 = Conv2d(4 * growth_rate, growth_rate, 3, 1, 1,
                                bias=False)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        bn = dict(train=train, update_stats=update_stats)
        y = self.Conv_0(F.relu(self.BatchNorm_0(x, **bn)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y, **bn)))
        return torch.cat([x, y], dim=1)


class DenseNet(FlaxNamedModule):
    """images NHWC [B, 32, 32, 3] -> logits [B, num_classes]."""

    def __init__(self, depth: int = 100, growth_rate: int = 12,
                 compression: float = 0.5, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = (depth - 4) // 6
        self.layers_per_block = n
        c = 2 * growth_rate
        self.Conv_0 = Conv2d(3, c, 3, 1, 1, bias=False)
        for block in range(3):
            for i in range(n):
                self.add_module(f"DenseLayer_{block * n + i}",
                                DenseLayer(c, growth_rate))
                c += growth_rate
            self.add_module(f"BatchNorm_{block}", BatchNorm(c))
            if block < 2:
                out = int(c * compression)
                self.add_module(f"Conv_{block + 1}",
                                Conv2d(c, out, 1, bias=False))
                c = out
        self.Dense_0 = Linear(c, num_classes)
        set_compute_dtype(self, dtype)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        n = self.layers_per_block
        x = self.Conv_0(x_nhwc.permute(0, 3, 1, 2))
        for block in range(3):
            for i in range(n):
                x = self.get_submodule(f"DenseLayer_{block * n + i}")(
                    x, train, update_stats)
            x = F.relu(self.get_submodule(f"BatchNorm_{block}")(
                x, train, update_stats))
            if block < 2:
                x = F.avg_pool2d(self.get_submodule(f"Conv_{block + 1}")(x),
                                 2, 2)
        return self.Dense_0(x.mean((2, 3))).to(torch.float32)
