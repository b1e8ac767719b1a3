"""BERT pretraining batches: the synthetic MLM/NSP stream of the
program's ``data/synthetic.py`` (uniform token ids over the vocabulary,
``mask_prob`` of the positions labelled with their own id and the rest
-1, segment ids 0, every position attended, uniform NSP labels), drawn
on the device. int32, as the program's loaders give them."""

from __future__ import annotations

from typing import Dict, List

import torch


def make_pool(config: Dict, workload: Dict, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    count = workload["pool_batches"]
    rows = config["data_parallel_workers"] * workload["batch_per_worker"]
    T, V = workload["seq_len"], config["model"]["vocab_size"]
    g = torch.Generator(device=device).manual_seed(seed)
    i32 = torch.int32
    ids = torch.randint(0, V, (count, rows, T), generator=g, device=device,
                        dtype=i32)
    masked = torch.rand((count, rows, T), generator=g,
                        device=device) < workload["mask_prob"]
    nsp = torch.randint(0, 2, (count, rows), generator=g, device=device,
                        dtype=i32)
    labels = torch.where(masked, ids, torch.full_like(ids, -1))
    zeros = torch.zeros((rows, T), dtype=i32, device=device)
    ones = torch.ones((rows, T), dtype=i32, device=device)
    return [{"input_ids": ids[c], "token_type_ids": zeros,
             "attention_mask": ones, "mlm_labels": labels[c],
             "nsp_labels": nsp[c]} for c in range(count)]


def meta_batch(config: Dict, workload: Dict, rows: int
               ) -> Dict[str, torch.Tensor]:
    """A batch of ``rows`` on the meta device: shapes without data."""
    meta, i32 = torch.device("meta"), torch.int32
    ids = torch.zeros((rows, workload["seq_len"]), dtype=i32, device=meta)
    return {"input_ids": ids, "token_type_ids": ids, "attention_mask": ids,
            "mlm_labels": ids,
            "nsp_labels": torch.zeros((rows,), dtype=i32, device=meta)}
