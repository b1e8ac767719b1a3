"""Everything the harness runs, found by name in files of its own.

- ``BENCHMARK.json`` at the checkout's root: the cells, the metrics and
  which cells report each;
- ``configs/<config>.json``: a model configuration, its reference family
  (``reference/<family>.py``), its traffic generator
  (``traffic/<generator>.py``) and how the program is built for it;
- ``workloads/<workload>.json``: a cell's traffic (batch, exchange,
  precision, warm steps) and the limits of its correctness check;
- ``metrics/<metric>.py``: a per-layer metric's reader.

A new cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


class Registry:
    """The entries of the checkout this file lies in."""

    def __init__(self):
        self.home = HERE
        path = HERE.parent / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json at {HERE.parent}")
        self.bench = json.loads(path.read_text())

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> Dict:
        return _load_json(self.home / "workloads" / f"{name}.json")

    def config(self, name: str) -> Dict:
        return _load_json(self.home / "configs" / f"{name}.json")

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if _reports(m, cell)]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if _reports(m, cell)]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``."""
        return load_file(self.home / "metrics" / f"{metric}.py",
                         f"gpubench_metric_{metric}").read

    def generator(self, name: str):
        return load_file(self.home / "traffic" / f"{name}.py",
                         f"gpubench_traffic_{name}")


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def load_file(path: Path, module_name: str):
    """Import a Python file by its path (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
