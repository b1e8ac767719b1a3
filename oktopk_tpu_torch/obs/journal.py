"""Event bus + unified run journal.

Counterpart of ``oktopk_tpu/obs/journal.py``, copied. One training run,
one JSONL file: per-step metrics, phase timings, quality flushes and
rollups, checkpoints and volume reports all flow through a single
:class:`EventBus` into a single :class:`RunJournal`, behind ONE
environment header (``autotune/journal.py::environment_header``, the
port's stack). Standalone journals (``autotune/journal.py``
``DecisionJournal``) keep writing their own files and, constructed with
``bus=``, forward every event to the bus (``decision`` renamed
``autotune_decision``).

The bus is host-side and synchronous — emit() fans an event dict out to
each subscriber in turn, over a snapshot of the subscribers, so a
subscriber may emit again (the rollup engine does). Subscriber
exceptions are swallowed and counted (``bus.dropped``): observability
must never be the reason a training step fails.
"""


from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

from oktopk_tpu_torch.autotune.journal import (  # noqa: F401
    environment_header,
    read_journal,
)
from oktopk_tpu_torch.obs.events import SCHEMA_VERSION  # noqa: F401


class EventBus:
    """Synchronous fan-out of event dicts to subscriber callables."""

    def __init__(self):
        self._subscribers: List[Callable[[Dict[str, Any]], None]] = []
        self.dropped = 0          # subscriber exceptions swallowed

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]):
        self._subscribers.append(fn)
        return fn

    def emit(self, event: str, **fields) -> Dict[str, Any]:
        entry = {"event": event, **fields}
        for fn in list(self._subscribers):
            try:
                fn(dict(entry))   # own copy: subscribers may mutate
            except Exception:
                self.dropped += 1
        return entry


class RunJournal:
    """The single per-run JSONL sink.

    Writes its own environment header directly (NOT via the bus), then
    subscribes to the bus and appends every event EXCEPT ``header`` —
    thin-view journals each write a header to their own standalone
    file, and forwarding those would break the one-header-per-run
    invariant that ``obs.events.validate_journal`` checks.

    ``path=None`` keeps entries in memory only (tests).
    """

    def __init__(self, path: Optional[str] = None,
                 bus: Optional[EventBus] = None, header: bool = True):
        self.path = path
        self.entries: List[Dict[str, Any]] = []
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(path, "w"):   # truncate: one journal per run
                pass
        if header:
            self._write({"event": "header", **environment_header()})
        if bus is not None:
            bus.subscribe(self._on_event)

    def _on_event(self, entry: Dict[str, Any]):
        if entry.get("event") == "header":
            return
        self._write(entry)

    def _write(self, entry: Dict[str, Any]):
        self.entries.append(entry)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")

    def record(self, event: str, **fields) -> Dict[str, Any]:
        """Direct append, bypassing the bus (for events that only the
        run journal should carry)."""
        entry = {"event": event, **fields}
        self._write(entry)
        return entry
