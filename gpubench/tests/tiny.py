"""Cells cut to a size a CPU test holds: the configurations' own files
with the program's ``bert_tiny`` widths, or VGG-16 at two images a
worker, and short pools."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HOME = Path(__file__).resolve().parent.parent

BERT_TINY = {"vocab_size": 1024, "hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 2, "intermediate_size": 128,
             "max_position_embeddings": 128}


def load(kind: str, name: str) -> dict:
    return json.loads((HOME / kind / f"{name}.json").read_text())


def cell(workload_name: str, batch: int = 2):
    """(config, workload) of a cell at a CPU test's size."""
    wl = load("workloads", workload_name)
    cfg = load("configs", wl["config"])
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    if cfg["family"] == "bert":
        cfg["model"].update(BERT_TINY)
        cfg["port"]["args"] = ["bert_tiny" if a == "bert_base" else a
                               for a in cfg["port"]["args"]]
        wl["seq_len"] = 32
        wl["port_args"] = ["--max-seq-length", "32"]
    wl["batch_per_worker"] = batch
    wl["pool_batches"] = wl["warm_steps"] + 1
    return cfg, wl
