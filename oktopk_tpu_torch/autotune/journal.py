"""JSONL decision journal — the journal format the run journal and the
autotuner share.

Counterpart of ``oktopk_tpu/autotune/journal.py`` (``_BUS_EVENT_REMAP``
:50, ``environment_header`` :53, ``DecisionJournal`` :77,
``read_journal`` :113). Every record is one JSON line, so a journal cut
by a crash still parses line by line. The first record is always an
environment header, so journals from different stacks can be told apart.
The port's header names its own stack:

  {"event": "header", "jax": null, "torch": "2.11.0+cu128",
   "cuda": "12.8", "device_kind": "NVIDIA H100 80GB HBM3",
   "platform": "gpu", "world_size": 1, "schema_version": 1}

``jax`` is None (the schema requires the key and allows None);
``platform`` is ``"gpu"`` (JAX's name for a CUDA backend) or ``"cpu"``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from oktopk_tpu_torch.obs.events import SCHEMA_VERSION

# standalone journal event name -> unified-bus event name. The file
# view keeps its historical "decision" name; the bus renames it so a
# consumer of the unified run journal can tell the streams apart.
_BUS_EVENT_REMAP = {"decision": "autotune_decision"}


def environment_header() -> Dict[str, Any]:
    """The torch/CUDA/device/world identification every journal leads
    with. ``world_size`` is the process group's size across processes,
    else the visible cards (1 on the CPU). Tolerant of a device that
    cannot be queried (the header must never be the reason a journal
    cannot be written)."""
    import torch

    hdr: Dict[str, Any] = {"jax": None, "torch": torch.__version__,
                           "cuda": torch.version.cuda,
                           "schema_version": SCHEMA_VERSION}
    try:
        if torch.cuda.is_available():
            hdr["device_kind"] = torch.cuda.get_device_name(0)
            hdr["platform"] = "gpu"
            world = torch.cuda.device_count()
        else:
            hdr["device_kind"] = "cpu"
            hdr["platform"] = "cpu"
            world = 1
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
        hdr["world_size"] = world
    except Exception:
        hdr.update(device_kind=None, platform=None, world_size=0)
    return hdr


class DecisionJournal:
    """Append-only JSONL writer. ``path=None`` keeps entries in memory only
    (tests, or callers that just want the plan). ``header=True`` writes
    the :func:`environment_header` as the first record.

    With ``bus=`` (an ``obs.journal.EventBus``) every recorded event is
    ALSO forwarded onto the unified run journal's bus — except the
    header, which belongs to this standalone file only (the run journal
    writes exactly one header of its own) — making this file a thin
    view of the unified stream."""

    def __init__(self, path: Optional[str] = None, header: bool = True,
                 bus=None):
        self.path = path
        self.bus = bus
        self.entries: List[Dict[str, Any]] = []
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            # truncate: one journal per tuner lifetime; re-tunes append
            with open(path, "w"):
                pass
        if header:
            self.record("header", **environment_header())

    def record(self, event: str, **fields) -> Dict[str, Any]:
        entry = {"event": event, **fields}
        self.entries.append(entry)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        if self.bus is not None and event != "header":
            self.bus.emit(_BUS_EVENT_REMAP.get(event, event), **fields)
        return entry


def read_journal(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL journal back into a list of entries."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
