"""VGG with BatchNorm for CIFAR (conv 3x3 padding 1 + BN + ReLU stacks,
2x2 max pools, flatten -> Linear head).

Counterpart of ``oktopk_tpu/models/vgg.py``. Layers are named after the
flax modules (``convs[i]`` = ``Conv_i``, ``bns[i]`` = ``BatchNorm_i``,
``dense`` = ``Dense_0``) so that ``convert.py`` maps one onto the other,
and ``jax_leaves`` lists the parameters in the JAX package's flat order.

BatchNorm is written out by hand to match flax exactly:
- batch variance E[x^2] - E[x]^2 (biased, clipped at 0), not the unbiased
  variance ``nn.BatchNorm2d`` puts into its running statistics;
- running statistics ``m * running + (1 - m) * batch`` with flax's
  momentum m = 0.9 (torch's momentum 0.1);
- y = (x - mean) * (rsqrt(var + eps) * scale) + bias, eps = 1e-5.
The head flattens in NHWC order, as the flax model does, so a narrow
config whose last feature map is wider than 1x1 still agrees.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

CFG = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if train:
            mean = x.mean((0, 2, 3))
            mean2 = (x * x).mean((0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.scale
        return y * mul[None, :, None, None] + self.bias[None, :, None, None]


class VGG(nn.Module):
    """CIFAR VGG from ``CFG``; input NHWC [B, 32, 32, 3] as the JAX model
    takes it, logits [B, num_classes]."""

    def __init__(self, name_cfg: str = "vgg16", num_classes: int = 10):
        super().__init__()
        self.name_cfg = name_cfg
        convs, bns = [], []
        c, hw = 3, 32                      # CIFAR images, NHWC [B, 32, 32, 3]
        for v in CFG[name_cfg]:
            if v == "M":
                hw //= 2
            else:
                convs.append(nn.Conv2d(c, v, 3, padding=1, bias=True))
                bns.append(BatchNorm(v))
                c = v
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.dense = nn.Linear(c * hw * hw, num_classes)

    def forward(self, x_nhwc, train: bool = True, update_stats: bool = True):
        x = x_nhwc.permute(0, 3, 1, 2)
        i = 0
        for v in CFG[self.name_cfg]:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = self.convs[i](x)
                x = self.bns[i](x, train=train, update_stats=update_stats)
                x = F.relu(x)
                i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense(x).to(torch.float32)

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, str]]:
        """(flax path, parameter, layout) in ``jax.tree.flatten`` order:
        module names sorted as strings (all ``BatchNorm_*`` first, then
        ``Conv_*``, then ``Dense_0``), ``bias`` before ``kernel``/``scale``.
        ``layout`` is how the JAX leaf relates to the torch tensor: "oihw"
        (conv kernel, JAX HWIO), "linear" (JAX [in, out]) or "same"."""
        mods = {}
        for i, m in enumerate(self.bns):
            mods[f"BatchNorm_{i}"] = [("bias", m.bias, "same"),
                                      ("scale", m.scale, "same")]
        for i, m in enumerate(self.convs):
            mods[f"Conv_{i}"] = [("bias", m.bias, "same"),
                                 ("kernel", m.weight, "oihw")]
        mods["Dense_0"] = [("bias", self.dense.bias, "same"),
                           ("kernel", self.dense.weight, "linear")]
        out = []
        for name in sorted(mods):
            for leaf, p, layout in mods[name]:
                out.append((f"{name}/{leaf}", p, layout))
        return out


def to_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """A torch parameter (or its gradient) in the JAX leaf's layout."""
    if layout == "oihw":
        return t.permute(2, 3, 1, 0)          # OIHW -> HWIO
    if layout == "linear":
        return t.t()                          # [out, in] -> [in, out]
    return t


def from_jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """Inverse of ``to_jax_layout``."""
    if layout == "oihw":
        return t.permute(3, 2, 0, 1)          # HWIO -> OIHW
    if layout == "linear":
        return t.t()
    return t
