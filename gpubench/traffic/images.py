"""CIFAR-shaped image batches: the program's ``data/synthetic.py``
images (standard normal NHWC [rows, 32, 32, 3] float32) with uniform
int32 labels over ``num_classes``, drawn on the device."""

from __future__ import annotations

from typing import Dict, List

import torch


def make_pool(config: Dict, workload: Dict, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    count = workload["pool_batches"]
    rows = config["data_parallel_workers"] * workload["batch_per_worker"]
    m = config["model"]
    side, chans = m["image_size"], m["in_channels"]
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((count, rows, side, side, chans), generator=g,
                         device=device)
    labels = torch.randint(0, m["num_classes"], (count, rows), generator=g,
                           device=device, dtype=torch.int32)
    return [{"image": images[c], "label": labels[c]} for c in range(count)]


def meta_batch(config: Dict, workload: Dict, rows: int
               ) -> Dict[str, torch.Tensor]:
    """A batch of ``rows`` on the meta device: shapes without data."""
    m, meta = config["model"], torch.device("meta")
    side = m["image_size"]
    return {"image": torch.empty((rows, side, side, m["in_channels"]),
                                 device=meta),
            "label": torch.zeros((rows,), dtype=torch.int32, device=meta)}
