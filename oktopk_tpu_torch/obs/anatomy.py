"""Step anatomy: the phase annotation contract and the trace analyser.

Counterpart of ``oktopk_tpu/obs/anatomy.py``, in three pieces:

1. **Naming contract** — ``scope_name(phase, bucket, level)`` gives names
   like ``anat/b003/exchange`` or ``anat/b000/lvl1/select``; ``SCOPE_PREFIX``,
   ``PHASES``, ``COLLECTIVE_PHASES``, ``parse_scope_level``,
   ``parse_scope`` and ``lane_of`` are copied. ``phase_scope(...)`` is a
   ``torch.profiler.record_function`` range (a ``nullcontext`` when
   annotations are off, ``OKTOPK_ANATOMY=0``), so the names reach the
   host thread of a ``torch.profiler`` trace (``user_annotation``) and,
   on the card, the stream that ran the range's kernels
   (``gpu_user_annotation``). A range reads nothing on the device and
   computes nothing, so a step is bit-identical with annotations on and
   off; it is opened only while a profiler runs (a range with no
   profiler would cost ~10 µs of host time for nothing).

   JAX's scopes nest inside one op path, and ``parse_scope_level``
   merges them (``…/anat/b000/anat/select/…`` is ``("select", 0,
   None)``). A ``torch.profiler`` range is an event of its own, so the
   port merges when it opens: each thread keeps a stack of the open
   contract components, a scope inherits the bucket, level and phase it
   does not name, and the range bears the merged name
   (``anat/b000/lvl1/select``). A scope that adds nothing to the
   enclosing one opens no range; a bare container (``phase_scope(
   bucket=0)``) opens ``anat/b000``, where JAX's ops outside every
   phase land on phase ``"other"``.

   On the card, ``loss.backward()`` launches its kernels from autograd's
   device thread, where the main thread's ``anat/fwd_bwd`` range is not
   open, so that range's device span would hold the forward kernels
   alone. :func:`backward_scope` reopens the range on the thread that
   runs the backward (see there).

2. **Trace analyser** — ``find_trace_file``, ``load_trace_events``, the
   interval helpers, ``phase_totals``, ``emit_anatomy`` and
   ``analyze_capture`` are copied; ``analyze_events`` is JAX's with two
   steps in front. First, a trace with any contract event of ``cat ==
   "gpu_user_annotation"`` is read on the device lane alone:
   ``torch.profiler`` writes every range twice on the card, once on the
   host thread (the dispatch, which ends before the device work does)
   and once on the stream, and the two clocks must not mix. A range's
   span on the stream runs from its first kernel to its last, idle gaps
   and other threads' kernels included (cuDNN even puts a few FFT
   kernels of the forward on a second stream, so the forward's range
   there spans the whole fwd/bwd), so the device lane is read as JAX
   reads a TPU's per-op lanes: each kernel, copy and fill is an event
   named by the innermost device range open at its start on its stream
   (:func:`device_events`), and ``count`` is the number of device
   activities. JAX's traces carry no ``cat``, and a CPU trace has only
   ``user_annotation``; they are read as they are. Second, nested ranges
   on one lane (one ``pid``/``tid``)
   get exclusive time: each instant of a lane belongs to the innermost
   range open then (the latest start; then the earliest end; then the
   longer name), so no instant is counted twice — as on JAX's per-op
   device lanes, where a container is never an op of its own. Events
   that never nest on a lane (JAX's fixture) give JAX's dict exactly.

3. **Journal events** — ``step_anatomy`` per bucket (model-level phases
   on bucket -1) and one ``overlap_report``, or one ``anatomy_warning``
   when there is nothing to attribute; the analysis never raises.

:func:`capture_pipeline_anatomy` is the pipeline capture (JAX's :452-584):
each phase of the pipeline run on its own under :func:`trace_annotation`
and synchronised, over the port's ops and the comm's verbs, in one
``torch.profiler`` window (``utils/profiling.py``).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import threading
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch

from oktopk_tpu_torch import settings

SCOPE_PREFIX = "anat"

# the phase vocabulary of the collectives pipeline, in pipeline order
PHASES = ("fwd_bwd", "select", "stage", "exchange", "combine", "optimizer")

# phases whose time is wire time; everything else in the contract is
# compute. Raw op names matching _COLLECTIVE_OPS inside a contract
# scope are classified collective regardless of phase (a psum inside a
# select region is still wire time).
COLLECTIVE_PHASES = frozenset({"exchange"})
_COLLECTIVE_OPS = re.compile(
    r"all-to-all|all-reduce|all-gather|reduce-scatter|collective-permute"
    r"|alltoall|allreduce|allgather|ppermute\b|\bpsum\b", re.I)

_BUCKET_RE = re.compile(r"^b(\d+)$")
# Optional hierarchy-level lane (collectives/hierarchical.py):
# ``anat/b000/lvl1/exchange`` — level 0 = intra-pod, level 1 = inter-pod.
_LEVEL_RE = re.compile(r"^lvl(\d+)$")

# the switch for the bit-identity checks and for opting the annotations
# out entirely (OKTOPK_ANATOMY=0)
_ENABLED = settings.ANATOMY

# the open contract components (phase, bucket, level) of each thread
_OPEN = threading.local()


def set_annotations(enabled: bool) -> bool:
    """Enable/disable the phase ranges; returns the previous setting."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    return prev


def annotations_enabled() -> bool:
    return _ENABLED


def scope_name(phase: Optional[str] = None,
               bucket: Optional[int] = None,
               level: Optional[int] = None) -> str:
    """The contract name: ``anat``, ``anat/b003``, ``anat/select``,
    ``anat/b003/select`` or — with a hierarchy level —
    ``anat/b003/lvl1/exchange``."""
    parts = [SCOPE_PREFIX]
    if bucket is not None:
        parts.append(f"b{int(bucket):03d}")
    if level is not None:
        parts.append(f"lvl{int(level)}")
    if phase is not None:
        parts.append(str(phase))
    return "/".join(parts)


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


@contextmanager
def _merged_range(phase, bucket, level):
    stack = _stack()
    outer = stack[-1] if stack else (None, None, None)
    merged = tuple(o if c is None else c
                   for c, o in zip((phase, bucket, level), outer))
    stack.append(merged)
    try:
        if merged == outer or not torch.autograd._profiler_enabled():
            yield
        else:
            with torch.profiler.record_function(scope_name(*merged)):
                yield
    finally:
        stack.pop()


def phase_scope(phase: Optional[str] = None, bucket: Optional[int] = None,
                level: Optional[int] = None):
    """A ``record_function`` range bearing the contract name merged with
    the enclosing scopes (nullcontext when annotations are disabled).
    Host-side only: no device sync, nothing computed."""
    if not _ENABLED:
        return nullcontext()
    return _merged_range(phase, bucket, level)


@contextmanager
def trace_annotation(phase: Optional[str] = None,
                     bucket: Optional[int] = None):
    """A host-side ``record_function`` range with the contract name (no
    merging) — the pipeline capture's annotation. Degrades to a no-op if
    the range cannot start."""
    name = scope_name(phase, bucket)
    try:
        cm = torch.profiler.record_function(name)
    except Exception:
        cm = nullcontext()
    with cm:
        yield


class _BackwardRange(torch.autograd.Function):
    """Identity on the loss whose backward, the first node autograd runs,
    opens the ``anat/fwd_bwd`` range on the thread that runs the
    backward, and queues its close at the end of the backward on that
    thread (autograd runs the queued callbacks on the thread that
    finishes the graph, the device thread for a graph on one card)."""

    @staticmethod
    def forward(ctx, loss):
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, grad):
        handle = torch.ops.profiler._record_function_enter_new(
            scope_name("fwd_bwd"), None)
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: torch.ops.profiler._record_function_exit._RecordFunction(
                handle))
        return grad


def backward_scope(loss: torch.Tensor) -> torch.Tensor:
    """``loss`` itself, or — on the card, with annotations on, while a
    profiler runs — ``loss`` through :class:`_BackwardRange`, so that the
    kernels ``loss.backward()`` launches from autograd's device thread
    fall in an ``anat/fwd_bwd`` range. On the CPU the backward runs on
    the calling thread, inside the caller's range already. The identity
    leaves every gradient bit-identical."""
    if (not _ENABLED or loss.device.type != "cuda"
            or not torch.autograd._profiler_enabled()):
        return loss
    return _BackwardRange.apply(loss)


def parse_scope_level(
        name: Any) -> Optional[Tuple[Optional[str], Optional[int],
                                     Optional[int]]]:
    """Extract ``(phase, bucket, level)`` from any name carrying the
    contract — a bare annotation (``anat/b000/select``,
    ``anat/b000/lvl1/exchange``) or a compiled-HLO op path
    (``jit(step)/.../anat/b000/anat/select/add``). Nested scopes merge:
    bucket, level and phase may come from different ``anat`` components.
    Returns None when the name carries no contract component; ``level``
    is None for legacy (single-level) names."""
    if not isinstance(name, str) or SCOPE_PREFIX not in name:
        return None
    parts = name.split("/")
    phase: Optional[str] = None
    bucket: Optional[int] = None
    level: Optional[int] = None
    seen = False
    for i, part in enumerate(parts):
        if part != SCOPE_PREFIX:
            continue
        seen = True
        j = i + 1
        if j < len(parts):
            m = _BUCKET_RE.match(parts[j])
            if m:
                bucket = int(m.group(1))
                j += 1
        if j < len(parts):
            m = _LEVEL_RE.match(parts[j])
            if m:
                level = int(m.group(1))
                j += 1
        if j < len(parts) and parts[j] in PHASES:
            phase = parts[j]
    return (phase, bucket, level) if seen else None


def parse_scope(name: Any) -> Optional[Tuple[Optional[str], Optional[int]]]:
    """Legacy ``(phase, bucket)`` view of :func:`parse_scope_level` —
    level-lane components are transparent, so names with and without a
    ``lvlN`` component round-trip identically."""
    parsed = parse_scope_level(name)
    return None if parsed is None else parsed[:2]


def lane_of(phase: Optional[str], name: str = "") -> str:
    """compute vs collective lane for one contract-scoped event."""
    if phase in COLLECTIVE_PHASES or _COLLECTIVE_OPS.search(name or ""):
        return "collective"
    return "compute"


# ---------------------------------------------------------------------------
# trace loading


def find_trace_file(path: str) -> Optional[str]:
    """Resolve ``path`` to one trace-event JSON file. A file path is
    used as-is; a profiler logdir is searched for the newest capture
    (JAX's ``plugins/profile/<ts>/*trace.json[.gz]``, then
    ``torch.profiler``'s ``*.pt.trace.json``, then any JSON)."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        return None
    patterns = ("**/perfetto_trace.json.gz", "**/*.trace.json.gz",
                "**/*.trace.json", "**/*.pt.trace.json", "**/*.json")
    candidates: List[str] = []
    for pat in patterns:
        candidates = glob.glob(os.path.join(path, pat), recursive=True)
        if candidates:
            break
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def load_trace_events(path: str) -> Tuple[List[Dict[str, Any]],
                                          Optional[str], Optional[str]]:
    """``(events, resolved_path, problem)``. Never raises: an
    unreadable/malformed trace returns ``([], path, reason)``. Accepts
    ``{"traceEvents": [...]}`` docs and bare event lists, gzipped or
    plain."""
    resolved = find_trace_file(path)
    if resolved is None:
        return [], None, f"no trace file under {path!r}"
    try:
        opener = gzip.open if resolved.endswith(".gz") else open
        with opener(resolved, "rt") as f:
            doc = json.load(f)
    except Exception as e:
        return [], resolved, f"unreadable trace: {e!r}"
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
    elif isinstance(doc, list):
        events = doc
    else:
        events = None
    if not isinstance(events, list):
        return [], resolved, "trace carries no traceEvents list"
    return [e for e in events if isinstance(e, dict)], resolved, None


# ---------------------------------------------------------------------------
# analysis


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in _merged(intervals))


def _intersection_ms(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    am, bm = _merged(a), _merged(b)
    i = j = 0
    total = 0.0
    while i < len(am) and j < len(bm):
        lo = max(am[i][0], bm[j][0])
        hi = min(am[i][1], bm[j][1])
        if hi > lo:
            total += hi - lo
        if am[i][1] <= bm[j][1]:
            i += 1
        else:
            j += 1
    return total


# the device activities of a torch.profiler trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(ranges: List[Dict[str, Any]], t: float):
    """The innermost of ``ranges`` (one lane's) open at time ``t``: the
    latest start, then the earliest end, then the longer name."""
    best, key = None, None
    for r in ranges:
        s, e = r["ts"], r["ts"] + r["dur"]
        if s <= t <= e:
            k = (s, -e, len(str(r["name"]).split("/")))
            if key is None or k > key:
                best, key = r, k
    return best


def device_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The contract events to read. With device ranges
    (``gpu_user_annotation``) in the trace, the device lane: each kernel,
    copy or fill on a stream becomes an event named by the innermost
    device range on that stream open at its start (the ranges themselves
    when the trace holds no device activity) — busy time, as a TPU's
    per-op device lanes give it, since a range's span on the stream runs
    from its first kernel to its last, host gaps included. Otherwise
    every event, as it is."""
    ranges = [e for e in events if e.get("cat") == "gpu_user_annotation"
              and e.get("ph") == "X"
              and parse_scope_level(e.get("name")) is not None
              and isinstance(e.get("ts"), (int, float))
              and isinstance(e.get("dur"), (int, float))]
    if not ranges:
        return events
    acts = [e for e in events if e.get("cat") in _DEVICE_CATS
            and e.get("ph") == "X" and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]
    if not acts:
        return ranges
    lanes: Dict[Any, List[Dict[str, Any]]] = {}
    for r in ranges:
        lanes.setdefault((r.get("pid"), r.get("tid")), []).append(r)
    out = []
    for a in acts:
        r = _innermost(lanes.get((a.get("pid"), a.get("tid")), []), a["ts"])
        if r is not None:
            out.append({"name": r["name"], "ph": "X", "ts": a["ts"],
                        "dur": a["dur"], "pid": a.get("pid"),
                        "tid": a.get("tid"), "cat": "gpu_user_annotation"})
    return out


def _sweep(bounds: List[float], items):
    """Each elementary interval ``(lo, hi)`` of the sorted ``bounds`` with
    the indices, ascending, of the ``items`` (``(start, end, ...)``, each
    start and end among the bounds) open over all of it."""
    n = len(items)
    starts = sorted(range(n), key=lambda i: items[i][0])
    ends = sorted(range(n), key=lambda i: items[i][1])
    active: set = set()
    si = ei = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        while si < n and items[starts[si]][0] <= lo:
            active.add(starts[si])
            si += 1
        while ei < n and items[ends[ei]][1] < hi:
            active.discard(ends[ei])
            ei += 1
        yield lo, hi, sorted(active)


def _exclusive(lane_spans: List[Tuple[float, float, int, int]]
               ) -> Dict[int, List[Tuple[float, float]]]:
    """{span id: its exclusive intervals} for the spans of one lane
    (``(start, end, name depth, id)``): each elementary interval goes to
    the innermost span open over it."""
    bounds = sorted({b for s, e, _d, _i in lane_spans for b in (s, e)})
    out: Dict[int, List[Tuple[float, float]]] = {
        i: [] for *_, i in lane_spans}
    for lo, hi, open_ in _sweep(bounds, lane_spans):
        if not open_:
            continue
        owner = max((lane_spans[j][0], -lane_spans[j][1], lane_spans[j][2],
                     lane_spans[j][3]) for j in open_)[3]
        iv = out[owner]
        if iv and iv[-1][1] == lo:
            iv[-1] = (iv[-1][0], hi)
        else:
            iv.append((lo, hi))
    return out


def analyze_events(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Attribute contract-scoped trace events into the step anatomy.

    Returns None when no contract event is present (the caller
    journals an ``anatomy_warning``). Times in the trace are
    microseconds (trace-event convention); everything returned is
    milliseconds."""
    spans: List[Tuple[float, float, Optional[str], Optional[int], str,
                      Optional[int]]] = []
    lanes: Dict[Any, List[Tuple[float, float, int, int]]] = {}
    for e in device_events(events):
        if e.get("ph") != "X":
            continue
        parsed = parse_scope_level(e.get("name"))
        if parsed is None:
            continue
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) or not isinstance(
                dur, (int, float)) or dur < 0:
            continue
        phase, bucket, level = parsed
        start, end = float(ts) / 1e3, (float(ts) + float(dur)) / 1e3
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
            (start, end, len(str(e.get("name")).split("/")), len(spans)))
        spans.append((start, end, phase, bucket,
                      lane_of(phase, str(e.get("name"))), level))
    if not spans:
        return None

    # each span's exclusive intervals (the whole span where nothing nests)
    owned: Dict[int, List[Tuple[float, float]]] = {}
    for lane_spans in lanes.values():
        owned.update(_exclusive(lane_spans))

    t0 = min(s for s, *_ in spans)
    # per-(bucket, phase) totals; phase-less contract events (a bare
    # "anat/b000" container) attribute to phase "other". Level-tagged
    # spans (hierarchical collectives) get their own lane key
    # ("lvl1/exchange") so the two levels of one phase never merge.
    per: Dict[Tuple[int, str], Dict[str, Any]] = {}
    compute_iv: List[Tuple[float, float]] = []
    comm_iv: List[Tuple[float, float]] = []
    for sid, (start, end, phase, bucket, lane, level) in enumerate(spans):
        pkey = phase or "other"
        if level is not None:
            pkey = f"lvl{int(level)}/{pkey}"
        key = (-1 if bucket is None else int(bucket), pkey)
        d = per.setdefault(key, {"ms": 0.0, "count": 0, "lane": lane})
        if level is not None:
            d["level"] = int(level)
        d["ms"] += sum(e - s for s, e in owned[sid])
        d["count"] += 1
        if lane == "collective":
            d["lane"] = "collective"
            comm_iv.extend(owned[sid])
        else:
            compute_iv.extend(owned[sid])

    compute_ms = _union_ms(compute_iv)
    comm_ms = _union_ms(comm_iv)
    overlap_ms = _intersection_ms(compute_iv, comm_iv)
    step_ms = max(e for _, e, *_ in spans) - t0
    ideal_ms = max(compute_ms, comm_ms)

    # critical-path attribution: sweep the span's elementary intervals;
    # each instant's duration is split equally among the phases active
    # then (idle gaps — host dispatch between probes, tails — land on
    # "idle"). The dominant entry is what a latency optimisation must
    # attack first.
    pieces = [(s, e, spans[sid][2]) for sid in sorted(owned)
              for s, e in owned[sid]]
    bounds = sorted({b for s, e, *_ in spans for b in (s, e)})
    critical: Dict[str, float] = {}
    for lo, hi, open_ in _sweep(bounds, pieces):
        if hi <= lo:
            continue
        active = [pieces[j][2] or "other" for j in open_]
        if not active:
            critical["idle"] = critical.get("idle", 0.0) + (hi - lo)
            continue
        share = (hi - lo) / len(active)
        for ph in active:
            critical[ph] = critical.get(ph, 0.0) + share
    ranked = sorted(((ph, ms) for ph, ms in critical.items()
                     if ph != "idle"), key=lambda kv: -kv[1])
    critical_phase = ranked[0][0] if ranked else None

    buckets: Dict[int, Dict[str, Dict[str, Any]]] = {}
    for (bucket, phase), d in sorted(per.items()):
        entry = {"ms": round(d["ms"], 4), "count": d["count"],
                 "lane": d["lane"]}
        if "level" in d:
            entry["level"] = d["level"]
        buckets.setdefault(bucket, {})[phase] = entry
    return {
        "buckets": buckets,
        "compute_ms": round(compute_ms, 4),
        "comm_ms": round(comm_ms, 4),
        "overlap_ms": round(overlap_ms, 4),
        "overlap_ratio": round(overlap_ms / comm_ms, 6) if comm_ms > 0
        else 0.0,
        "step_ms": round(step_ms, 4),
        "ideal_ms": round(ideal_ms, 4),
        "serialization_ms": round(max(0.0, step_ms - ideal_ms), 4),
        "critical_path": {ph: round(ms, 4)
                          for ph, ms in sorted(critical.items())},
        "critical_phase": critical_phase,
        "events": len(spans),
    }


def phase_totals(analysis: Dict[str, Any]) -> Dict[str, float]:
    """Per-phase-family total ms summed across buckets — the shape
    ``RegressionDetector.observe_phases`` checks limits against."""
    totals: Dict[str, float] = {}
    for phases in analysis.get("buckets", {}).values():
        for ph, d in phases.items():
            # level-tagged keys ("lvl1/exchange") fold into their phase
            # family so regression limits keyed by phase keep applying
            if _LEVEL_RE.match(ph.split("/", 1)[0]):
                ph = ph.split("/", 1)[1] if "/" in ph else "other"
            totals[ph] = round(totals.get(ph, 0.0) + float(d["ms"]), 4)
    return totals


def emit_anatomy(bus, analysis: Optional[Dict[str, Any]], step: int = 0,
                 source: str = "trace",
                 warn_reason: Optional[str] = None,
                 warn_path: Optional[str] = None) -> None:
    """Journal one capture: ``step_anatomy`` per bucket + one
    ``overlap_report`` — or a single ``anatomy_warning`` when there is
    nothing to attribute. ``bus`` may be an EventBus or a RunJournal
    (anything with ``emit``/``record``)."""
    if bus is None:
        return
    put = getattr(bus, "emit", None) or getattr(bus, "record")
    if analysis is None:
        put("anatomy_warning", step=int(step),
            reason=str(warn_reason or "empty or malformed trace"),
            path=warn_path, source=source)
        return
    for bucket, phases in sorted(analysis["buckets"].items()):
        levels = sorted({d["level"] for d in phases.values()
                         if "level" in d})
        extra = {"levels": levels} if levels else {}
        put("step_anatomy", step=int(step), bucket=int(bucket),
            phases=phases,
            total_ms=round(sum(d["ms"] for d in phases.values()), 4),
            source=source, **extra)
    put("overlap_report", step=int(step),
        compute_ms=analysis["compute_ms"], comm_ms=analysis["comm_ms"],
        overlap_ms=analysis["overlap_ms"],
        overlap_ratio=analysis["overlap_ratio"],
        step_ms=analysis["step_ms"], ideal_ms=analysis["ideal_ms"],
        serialization_ms=analysis["serialization_ms"],
        critical_path=analysis["critical_path"],
        critical_phase=analysis["critical_phase"],
        num_buckets=len(analysis["buckets"]),
        events=analysis["events"], source=source)


def analyze_capture(path: str, bus=None, step: int = 0,
                    source: str = "trace") -> Optional[Dict[str, Any]]:
    """Load + analyze + journal one captured trace. Never raises; a
    missing/malformed/contract-free trace journals an
    ``anatomy_warning`` and returns None."""
    try:
        events, resolved, problem = load_trace_events(path)
        analysis = analyze_events(events) if events else None
        if analysis is None and problem is None:
            problem = "no anatomy-scoped events in trace"
        emit_anatomy(bus, analysis, step=step, source=source,
                     warn_reason=problem, warn_path=resolved or path)
        return analysis
    except Exception as e:   # pragma: no cover - belt and braces
        emit_anatomy(bus, None, step=step, source=source,
                     warn_reason=f"analysis failed: {e!r}", warn_path=path)
        return None


# ---------------------------------------------------------------------------
# pipeline capture


def capture_pipeline_anatomy(cfg, comm, logdir: str, num_buckets: int = 4,
                             iters: int = 3, bus=None, step: int = 0,
                             fwd_bwd_elems: int = 1 << 16, device=None,
                             bucket_sizes=None):
    """Capture + attribute one step anatomy over ``comm`` (``cfg.
    num_workers`` workers).

    Each phase of the pipeline runs on its own, synchronised, under a
    host :func:`trace_annotation` (JAX's probes, in JAX's order: a
    matmul-chain fwd/bwd stand-in; per bucket — ``cfg.n`` split evenly in
    ``num_buckets``, or ``bucket_sizes`` (summing to ``cfg.n``), a
    model's own buckets — select, stage, exchange and combine; the SGD-
    momentum optimizer on the flat vector), one annotation per (bucket,
    phase) per iteration, in one ``torch.profiler`` window. On the card
    the selects and packs launch the compaction kernel and each range
    also lands on the stream, which the analyser reads. Dispatch is
    serial by construction, so ``overlap_ratio`` is the floor of an
    un-pipelined step.

    Returns the analysis dict (journalled on ``bus`` when given), or
    None when the profiler cannot start."""
    import numpy as np

    from oktopk_tpu_torch import resolve_device
    from oktopk_tpu_torch.ops.compaction import (pack_by_region,
                                                 select_by_threshold)
    from oktopk_tpu_torch.ops.select import scatter_sparse
    from oktopk_tpu_torch.ops.topk import k2threshold_method
    from oktopk_tpu_torch.utils.profiling import (_start_profiler,
                                                  _stop_profiler)

    dev = resolve_device(device)
    P = int(cfg.num_workers)
    if bucket_sizes is None:
        nb = max(1, int(num_buckets))
        sizes = [cfg.n // nb] * nb
        sizes[-1] += cfg.n - sum(sizes)
    else:
        sizes = [int(s) for s in bucket_sizes]
        if sum(sizes) != cfg.n:
            raise ValueError(f"bucket sizes {sizes} do not sum to "
                             f"cfg.n={cfg.n}")
    rng = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(a).to(dev)

    def sync(_=None):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    probes = []   # (phase, bucket, fn) in dispatch order

    # model-level fwd/bwd stand-in: a matmul-chain gradient sized to be
    # visible next to the bucket probes
    d = max(32, int(np.sqrt(fwd_bwd_elems)) // 32 * 32)
    w = put(rng.randn(d, d).astype(np.float32))
    x0 = put(rng.randn(8, d).astype(np.float32))

    def fwd_bwd():
        wv = w.detach().requires_grad_(True)
        loss = torch.sum(torch.tanh(x0 @ wv @ wv.T) ** 2)
        return torch.autograd.grad(loss, wv)[0]

    sync(fwd_bwd())
    probes.append(("fwd_bwd", None, fwd_bwd))

    for bi, n_b in enumerate(sizes):
        cfg_b = cfg.replace(n=n_b, bucket_index=bi)
        k_b, cap_p, cap_g = cfg_b.k, cfg_b.cap_pair, cfg_b.cap_gather
        g_b = put(rng.randn(n_b).astype(np.float32))
        bnd = torch.tensor([round(i * n_b / P) for i in range(P + 1)],
                           dtype=torch.int32, device=dev)

        def sel(x=g_b, k=k_b, cap=cap_g, c=cfg_b):
            return select_by_threshold(x, k2threshold_method(
                x.abs(), k, c.threshold_method, c.bisect_iters), cap)

        sync(sel())
        t_b = k2threshold_method(g_b.abs(), k_b, cfg_b.threshold_method,
                                 cfg_b.bisect_iters)

        def stage(x=g_b, t=t_b, b=bnd, cap=cap_p):
            return pack_by_region(x, t, b, P, cap)

        s_vals, s_idx, _ = stage()
        sv = s_vals.unsqueeze(0).expand((P,) + tuple(s_vals.shape))
        si = s_idx.unsqueeze(0).expand((P,) + tuple(s_idx.shape))
        gv = put(rng.randn(P, cap_g).astype(np.float32))

        def exchange(a=sv, b=si, c=gv):
            # the stacked comm's verbs are views: the copies stand in for
            # the bytes a wire would move into each worker's buffers
            return (comm.all_to_all(a).contiguous(),
                    comm.all_to_all(b).contiguous(),
                    comm.all_gather(c).contiguous())

        rv, ri, _ = exchange()

        def combine(a=rv[0], b=ri[0], g=g_b, n=n_b):
            return torch.where(scatter_sparse(n, a, b) != 0.0,
                               torch.zeros((), device=g.device), g)

        sync(combine())
        probes.append(("select", bi, sel))
        probes.append(("stage", bi, stage))
        probes.append(("exchange", bi, exchange))
        probes.append(("combine", bi, combine))

    # model-level optimizer: SGD-momentum update on the flat vector
    gm = put(rng.randn(cfg.n).astype(np.float32))
    pm = torch.zeros_like(gm)

    def opt():
        m = 0.9 * pm + gm
        return pm - 0.1 * m, m

    sync(opt())
    probes.append(("optimizer", None, opt))

    os.makedirs(logdir, exist_ok=True)
    prof = _start_profiler()
    if prof is None:
        return None
    try:
        for _ in range(max(1, int(iters))):
            for phase, bucket, fn in probes:
                with trace_annotation(phase, bucket):
                    fn()
                    sync()
    finally:
        path = _stop_profiler(prof, os.path.join(logdir,
                                                 "anatomy.pt.trace.json"))
    if path is None:
        return None
    return analyze_capture(path, bus=bus, step=step, source="host_probe")
