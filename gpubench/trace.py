"""Spans from the benchmark's side and the reduction of a profiler trace.

``StepClock`` records CUDA events at the start of each training step,
around the program's gradient exchange (``trainer.grad_step``, wrapped
on the instance) and at the step's end, and splits each step into
forward and backward (with the flat-gradient copy), the exchange, and
the optimizer; the starts also give each step's period.

``profile_steps`` runs steps under ``torch.profiler``, then a
synchronise, writes the Chrome trace to a temporary file under
``TMPDIR``, reads it back and deletes it. The device's own numbers come
from a trace of the device alone (CUPTI's activity records: the host's
ops untraced, so the profiler adds little to a host-paced step); the
names of the idle gaps from a second trace with the host's ops, whose
own cost lengthens the gaps it names. ``summarize`` reduces the events:
the window (first device activity to last), the device's busy time in it
(the union of kernels, copies and sets), each kernel's time and count,
and, where the host's ops were traced, the idle gaps between device work
named by the innermost host range open in the middle of each gap.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class StepClock:
    def __init__(self, trainer):
        self.steps: List[Dict[str, torch.cuda.Event]] = []
        inner = trainer.grad_step

        def grad_step(flat):
            self._mark("exchange_start")
            out = inner(flat)
            self._mark("exchange_end")
            return out

        trainer.grad_step = grad_step

    def _mark(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][name] = ev

    def start(self) -> None:
        self.steps.append({})
        self._mark("start")

    def end(self) -> None:
        self._mark("end")

    def splits(self) -> List[Dict[str, float]]:
        """Per step, after a synchronise: ms of each part, and
        ``period_ms``, from the step's start to the next's (none for the
        last): the step with the device's idle time around it."""
        out = []
        for m, nxt in zip(self.steps, self.steps[1:] + [None]):
            period = (m["start"].elapsed_time(nxt["start"]) if nxt
                      else None)
            out.append({"period_ms": period,
                "fwd_bwd_ms": m["start"].elapsed_time(m["exchange_start"]),
                "collective_ms": m["exchange_start"].elapsed_time(
                    m["exchange_end"]),
                "optimizer_ms": m["exchange_end"].elapsed_time(m["end"]),
                "step_ms": m["start"].elapsed_time(m["end"])})
        return out


def profile_steps(run_steps: Callable[[], None], host: bool) -> List[Dict]:
    """The trace events of ``run_steps()`` under the profiler: the
    device's activity, and with ``host`` the host's ops too."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    with profile(activities=acts) as prof:
        run_steps()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[Dict]) -> Optional[Dict]:
    """Busy and window seconds, per-kernel seconds and counts, the top
    device ops, and idle gaps by host range (empty without host ops);
    None when the trace holds no device work."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, s + d, e["name"]))
        elif e.get("cat") in HOST_CATS:
            host.append((s, s + d, e["name"]))
    if not dev:
        return None
    busy = _merge([(s, e) for s, e, _ in dev])
    w0, w1 = busy[0][0], busy[-1][1]
    per_kernel = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        per_kernel[name][0] += (e - s) * 1e-6
        per_kernel[name][1] += 1
    edges = [x for span in busy for x in span]
    gaps = sorted((0.5 * (a + b), b - a)
                  for a, b in zip(edges[1:-1:2], edges[2::2]) if b > a)
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "kernels": {k: {"seconds": v[0], "count": v[1]}
                        for k, v in per_kernel.items()},
            "device_ops": _top({k: v[0] for k, v in per_kernel.items()}),
            "idle_gaps": _top(_name_gaps(gaps, host)) if host else []}


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host range open at
    each gap's middle (``gaps``: (middle, length) sorted by middle): a
    sweep with the open ranges in a heap by duration."""
    host = sorted(host)
    out, heap, i = defaultdict(float), [], 0
    for mid, length in gaps:
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "(no host range)"] += length * 1e-6
    return out


def _top(d: Dict[str, float]) -> List:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_time(summary: Dict, prefixes) -> tuple:
    """(seconds, count of launches) of the kernels whose names start
    with any of ``prefixes``."""
    secs, count = 0.0, {}
    for name, rec in summary["kernels"].items():
        bare = name[5:] if name.startswith("void ") else name
        for p in prefixes:
            if bare.startswith(p):
                secs += rec["seconds"]
                count[p] = count.get(p, 0) + rec["count"]
    return secs, count
