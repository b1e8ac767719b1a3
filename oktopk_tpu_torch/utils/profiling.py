"""Profiling: host phase timers, the per-step scalar log, bounded
profiler windows and memory statistics.

Counterpart of ``oktopk_tpu/utils/profiling.py``:

- :class:`PhaseTimers` (:36) and :class:`MetricWriter` (:123) are pure
  Python, copied: the same tables, summaries and ``scalars.csv`` bytes;
- :class:`TraceWindow` (:176) and :func:`trace_window` (:209) run over
  ``torch.profiler`` (CPU activity, and CUDA where a card is present)
  instead of ``jax.profiler``; at the window's end they write one Chrome
  trace (``chrome://tracing``, Perfetto) under the window's logdir. A
  profiler that cannot start (another one is running, or no profiler
  support) leaves the traced code running, as JAX's ``trace_window``
  does;
- :func:`device_memory_stats` (:235) reads ``torch.cuda.memory_stats``
  under JAX's keys (``bytes_in_use``, ``peak_bytes_in_use``,
  ``bytes_limit``), ``{}`` for a CPU device;
- :func:`host_memory_stats` (:252), copied.
"""

from __future__ import annotations

import csv
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class PhaseTimers:
    """Rolling per-phase wall-clock accounting.

    ``with timers.phase("step"): ...`` accumulates a sample; ``table()``
    renders the reference-style mean/total dump (VGG/allreducer.py:379-439),
    and ``maybe_log(step, logger)`` prints it every ``every`` steps then
    resets, like the reference's 50-step cadence.
    """

    def __init__(self, every: int = 50, sink=None):
        self.every = every
        # optional obs.tracing.ChromeTraceSink (anything with
        # add(name, ts_s, dur_s)): every phase sample also becomes a
        # Chrome trace-event for chrome://tracing / Perfetto
        self.sink = sink
        self._samples: Dict[str, list] = defaultdict(list)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self._samples[name].append(dur)
            if self.sink is not None:
                self.sink.add(name, t0, dur)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def table(self) -> str:
        rows = [f"{'phase':<14}{'mean_ms':>10}{'total_s':>10}{'count':>8}"]
        for name in sorted(self._samples):
            s = self._samples[name]
            if not s:
                # defaultdict access can register a phase with no
                # samples; render it instead of dividing by zero
                rows.append(f"{name:<14}{'-':>10}{'-':>10}{0:>8d}")
                continue
            mean = sum(s) / len(s)
            rows.append(
                f"{name:<14}{mean * 1e3:>10.2f}{sum(s):>10.3f}{len(s):>8d}")
        return "\n".join(rows)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Machine-readable form of :meth:`table` (for the run
        journal's ``phase`` events): mean/min/max and nearest-rank
        p50/p95 per phase, so host-phase spread sits next to the device
        anatomy in one report (scripts/obs_report.py)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, s in self._samples.items():
            if not s:
                out[name] = {"mean_ms": 0.0, "min_ms": 0.0, "max_ms": 0.0,
                             "p50_ms": 0.0, "p95_ms": 0.0,
                             "total_s": 0.0, "count": 0.0}
                continue
            srt = sorted(s)
            cnt = len(srt)

            def rank(q: float) -> float:
                # nearest-rank percentile: exact order statistic, no
                # interpolation inventing never-observed durations
                return srt[min(cnt - 1, max(0, int(q * cnt + 0.5) - 1))]

            out[name] = {
                "mean_ms": sum(s) / cnt * 1e3,
                "min_ms": srt[0] * 1e3,
                "max_ms": srt[-1] * 1e3,
                "p50_ms": rank(0.50) * 1e3,
                "p95_ms": rank(0.95) * 1e3,
                "total_s": float(sum(s)),
                "count": float(cnt),
            }
        return out

    def reset(self) -> None:
        self._samples.clear()

    def maybe_log(self, step: int, logger) -> bool:
        if self.every and step % self.every == 0 and self._samples:
            logger.info("phase timing @ step %d\n%s", step, self.table())
            self.reset()
            return True
        return False


class MetricWriter:
    """Append-only per-step scalar log: ``<logdir>/scalars.csv``.

    Stands in for the reference's rank-0 tensorboardX writer
    (VGG/main_trainer.py:170-172, VGG/dl_trainer.py:611-613) without the
    dependency; the CSV loads straight into pandas for the same plots.
    """

    def __init__(self, logdir: str, filename: str = "scalars.csv"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._existing_fields: Optional[list] = None
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            with open(self.path, newline="") as f:
                header = next(csv.reader(f), None)
            if header and header[0] == "step":
                self._existing_fields = header[1:]
        self._file = open(self.path, "a", newline="")
        self._writer = csv.writer(self._file)
        self._fields: Optional[list] = None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self._fields is None:
            self._fields = sorted(scalars)
            if self._existing_fields is None:
                self._writer.writerow(["step"] + self._fields)
            elif self._existing_fields != self._fields:
                # resuming with a different metric set: rotate to a fresh
                # file rather than appending misaligned rows
                self._file.close()
                base, ext = os.path.splitext(self.path)
                i = 1
                while os.path.exists(f"{base}-{i}{ext}"):
                    i += 1
                self.path = f"{base}-{i}{ext}"
                self._file = open(self.path, "a", newline="")
                self._writer = csv.writer(self._file)
                self._writer.writerow(["step"] + self._fields)
        row = [step] + [format(float(scalars.get(k, float("nan"))), ".8g")
                        for k in self._fields]
        self._writer.writerow(row)
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TraceWindow:
    """A ``torch.profiler`` window from ``start_step`` to ``num_steps``
    later: ``on_step(step)`` starts it on the first step inside the
    window and stops it on the first step past it, writing the Chrome
    trace to ``path`` (under ``logdir``). A window whose profiler cannot
    start stays off (``path`` None)."""

    def __init__(self, logdir: str, start_step: int, num_steps: int = 3):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.path: Optional[str] = None
        self._prof = None

    def on_step(self, step: int) -> None:
        # range test, not equality: a resumed run may first observe a step
        # past start_step and should still capture the remaining window
        if (self.start_step <= step < self.stop_step
                and self._prof is None and self.path is None):
            self._prof = _start_profiler()
        elif step >= self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self.path = _stop_profiler(prof, os.path.join(
                self.logdir, f"trace_steps{self.start_step}-"
                f"{self.stop_step - 1}.json"))


def _start_profiler():
    """A started ``torch.profiler.profile`` (CPU, plus CUDA where a card
    is present), or None when it cannot start: one is running already (a
    second would take its session over), or starting raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd._profiler_enabled():
        return None
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts)
        prof.start()
        return prof
    except Exception:
        return None


def _stop_profiler(prof, path: str) -> Optional[str]:
    """Stop ``prof`` (the card synchronised first) and write its Chrome
    trace to ``path``; None when that fails."""
    import torch

    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        prof.export_chrome_trace(path)
        return path
    except Exception:
        return None


@contextmanager
def trace_window(logdir: str):
    """Trace everything inside the block into one Chrome trace under
    ``logdir`` (``trace.json``). A no-op when the profiler cannot start:
    the traced code runs either way."""
    prof = _start_profiler()
    try:
        yield
    finally:
        if prof is not None:
            _stop_profiler(prof, os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None) -> Dict[str, float]:
    """Device memory of one card under JAX's keys (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``) from ``torch.cuda``; ``{}``
    for a CPU device, or without a card."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                            0)),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                                 0)),
            "bytes_limit": float(torch.cuda.get_device_properties(
                dev).total_memory)}


def host_memory_stats() -> Dict[str, float]:
    """Host RSS via /proc (psutil-free)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return {"host_rss_bytes": float(line.split()[1]) * 1024}
    except OSError:
        pass
    return {}
