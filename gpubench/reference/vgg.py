"""VGG with BatchNorm for CIFAR, plain PyTorch.

Simonyan & Zisserman (arXiv:1409.1556), configuration D, as the Ok-Topk
reference's ``VGG/`` trains it on CIFAR-10: 3x3 convolutions with
padding 1 and a bias, each followed by BatchNorm (batch statistics in
training, eps 1e-5) and ReLU, 2x2 max pools, then one linear layer over
the flattened 1x1x512 map. The loss is the mean softmax cross entropy.

Parameters are named and shaped as the flax model of the JAX package
(``Conv_i`` kernels HWIO, ``BatchNorm_i`` scale and bias, ``Dense_0``
kernel [in, out]) and ordered as ``jax.tree.flatten`` orders them.
Images come NHWC [B, 32, 32, 3]; the head flattens in NHWC order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.precision import conv2d, dense


def _convs(m: Dict):
    """(in, out) channels of each convolution, and the map's side after
    the last pool."""
    chans, c, hw = [], m["in_channels"], m["image_size"]
    for v in m["layers"]:
        if v == "M":
            hw //= 2
        else:
            chans.append((c, v))
            c = v
    return chans, c, hw


def leaf_table(m: Dict) -> List[Tuple[str, Tuple[int, ...], Tuple]]:
    """(flax path, JAX shape, init) in ``jax.tree.flatten`` order: the
    program's lecun-normal kernels (std sqrt(1/fan_in)), zero biases,
    BatchNorm scale 1."""
    chans, c, hw = _convs(m)
    out = []
    for i, (ci, co) in enumerate(chans):
        out.append((f"BatchNorm_{i}/bias", (co,), ("zeros",)))
        out.append((f"BatchNorm_{i}/scale", (co,), ("ones",)))
        out.append((f"Conv_{i}/bias", (co,), ("zeros",)))
        out.append((f"Conv_{i}/kernel", (3, 3, ci, co),
                    ("normal", 1.0 / math.sqrt(9 * ci))))
    fin = c * hw * hw
    out.append(("Dense_0/bias", (m["num_classes"],), ("zeros",)))
    out.append(("Dense_0/kernel", (fin, m["num_classes"]),
                ("normal", 1.0 / math.sqrt(fin))))
    out.sort(key=lambda t: tuple(t[0].split("/")))
    return out


def forward(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            m: Dict, rng, precision: str) -> torch.Tensor:
    x = batch["image"].permute(0, 3, 1, 2)
    i = 0
    for v in m["layers"]:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w = p[f"Conv_{i}/kernel"].permute(3, 2, 0, 1)       # HWIO -> OIHW
        x = conv2d(x, w, 1, precision) + p[f"Conv_{i}/bias"].view(1, -1, 1, 1)
        x = F.batch_norm(x, None, None, p[f"BatchNorm_{i}/scale"],
                         p[f"BatchNorm_{i}/bias"], training=True,
                         eps=m["batch_norm_eps"])
        x = F.relu(x)
        i += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return dense(x, p["Dense_0/kernel"], p["Dense_0/bias"], precision)


def loss(p, batch, m: Dict, rng, precision: str) -> torch.Tensor:
    return F.cross_entropy(forward(p, batch, m, rng, precision),
                           batch["label"].long())


def uses_dropout(m: Dict) -> bool:
    return False
