"""Anomaly-triggered profiler windows and Chrome trace export.

Counterpart of ``oktopk_tpu/obs/tracing.py``, copied but for the
profiler:

- :class:`AnomalyTracer` (:32-110) subscribes to the run-journal event
  bus: a ``guard_trip``, ``fallback`` or breached ``quality_rollup``
  ARMS it, the next ``on_step()`` opens a bounded ``torch.profiler``
  window (``utils/profiling.py``'s ``_start_profiler``) over the
  following N steps, and its close writes the Chrome trace and journals
  ``trace_captured`` with JAX's fields, the trigger included
  (``"guard_trip@step12"``). One window at a time, at most
  ``max_captures``. A profiler that cannot start — another one is
  running, such as ``--trace-at``'s ``TraceWindow`` — journals the window
  with ``logdir: null``, as JAX's does: observability never takes down
  training. The trace file carries the process's rank
  (``anomaly_step{S}/rank{r}.pt.trace.json``), so processes sharing a
  filesystem do not overwrite each other. The tracer does no collective:
  a ``guard_trip`` comes from the guard's agreed flags (an int32 psum),
  so every rank opens the same window, and a rank that arms alone on its
  own rollup cannot hang the others.
- :class:`ChromeTraceSink` (:113-164) collects host-phase samples
  (``PhaseTimers``) as Chrome trace-event ``"X"`` events, one lane per
  contract family (``obs/anatomy.py``'s ``parse_scope``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from oktopk_tpu_torch.obs.anatomy import parse_scope, scope_name

_TRIGGERS = ("guard_trip", "fallback", "quality_rollup")


class AnomalyTracer:
    """Arms on anomaly events, captures a bounded trace window."""

    def __init__(self, logdir: str, bus=None, num_steps: int = 3,
                 max_captures: int = 3, rank: int = 0):
        self.logdir = logdir
        self.bus = bus
        self.num_steps = max(1, int(num_steps))
        self.max_captures = max(0, int(max_captures))
        self.rank = int(rank)
        self.captures: List[Dict[str, Any]] = []
        self._armed: Optional[str] = None      # trigger description
        self._start_step: Optional[int] = None
        self._active_dir: Optional[str] = None
        self._prof = None
        if bus is not None:
            bus.subscribe(self._on_event)

    @property
    def active(self) -> bool:
        return self._start_step is not None

    def _on_event(self, entry: Dict[str, Any]):
        event = entry.get("event")
        if event not in _TRIGGERS:
            return
        if event == "quality_rollup" and not entry.get("breaches"):
            return                 # only breached rollups are anomalies
        if self.active or self._armed is not None:
            return                 # one window at a time
        if len(self.captures) >= self.max_captures:
            return
        self._armed = f"{event}@step{entry.get('step')}"

    def on_step(self, step: int):
        """Call once per training step (host side, before the step)."""
        step = int(step)
        if self.active:
            if step >= self._start_step + self.num_steps:
                self._stop(step)
            return
        if self._armed is not None:
            self._start(step)

    def _start(self, step: int):
        from oktopk_tpu_torch.utils.profiling import _start_profiler
        d = os.path.join(self.logdir, f"anomaly_step{step}")
        self._prof = _start_profiler()
        # journal the window anyway when the profiler cannot start
        self._active_dir = d if self._prof is not None else None
        self._start_step = step

    def _stop(self, step: int):
        from oktopk_tpu_torch.utils.profiling import _stop_profiler
        if self._prof is not None:
            prof, self._prof = self._prof, None
            path = _stop_profiler(prof, os.path.join(
                self._active_dir, f"rank{self.rank}.pt.trace.json"))
            if path is None:
                self._active_dir = None
        cap = {"step": int(step), "start_step": int(self._start_step),
               "num_steps": int(step - self._start_step),
               "logdir": self._active_dir,
               "trigger": self._armed or "unknown"}
        self.captures.append(cap)
        self._armed = None
        self._start_step = None
        self._active_dir = None
        if self.bus is not None:
            self.bus.emit("trace_captured", **cap)

    def finish(self, step: int):
        """Force-close any open window (end of train())."""
        if self.active:
            self._stop(int(step))


class ChromeTraceSink:
    """Collects host phase samples as Chrome trace-event JSON.

    Each bucket/phase family gets its own tid (first-seen order), so
    Perfetto renders one row per family instead of interleaving every
    sample on a single track; ``write()`` prepends trace metadata
    ("M") events naming the process and each lane.
    """

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._lanes: Dict[str, int] = {}

    def _lane(self, name: str) -> str:
        """Lane key for one sample: anatomy-contract names group by
        (bucket, phase) family; anything else gets its own row."""
        parsed = parse_scope(name)
        if parsed is not None and parsed != (None, None):
            return scope_name(*parsed)
        return name

    def add(self, name: str, ts_s: float, dur_s: float):
        """One complete ("X") event; times in seconds (host clock)."""
        tid = self._lanes.setdefault(self._lane(name), len(self._lanes))
        self.events.append({
            "name": name, "ph": "X", "pid": 0, "tid": tid,
            "ts": float(ts_s) * 1e6, "dur": float(dur_s) * 1e6,
        })

    def _metadata_events(self) -> List[Dict[str, Any]]:
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "oktopk host phases"},
        }]
        for lane, tid in sorted(self._lanes.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": lane}})
            meta.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"sort_index": tid}})
        return meta

    def write(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self._metadata_events() + self.events,
                       "displayTimeUnit": "ms"}, f)
        return path
