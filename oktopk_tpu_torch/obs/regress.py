"""Step-time regression detection against the BENCH trajectory.

Counterpart of ``oktopk_tpu/obs/regress.py`` (``scan_bench_records``
:36, ``RegressionDetector`` :76), copied. The repository root holds
``BENCH_r*.json`` records, each with a ``parsed`` dict of per-algorithm
millisecond timings. Those records are the JAX package's measurements,
not the card's: a baseline taken from them (``--obs-regress-key``)
compares the port's steps with the JAX package's history, as the JAX
command line does, and says nothing of what the card should take. A
caller with a baseline of its own passes ``baseline_ms`` to
:class:`RegressionDetector` directly.

The detector is advisory: it never throws. With no baseline available
(no records, none carrying the key, or only malformed files) it makes
no step-time judgements, but journals one ``baseline_warning`` event. A
warmup window skips the first observations. ``observe_quality`` checks
fidelity summary fields against ``quality_limits`` and
``observe_phases`` per-phase durations against ``phase_limits``, each
journalling ``regression`` events keyed ``quality:<field>`` and
``phase:<name>``.
"""


from __future__ import annotations

import glob
import json
import os
import statistics
from typing import Any, Dict, List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def scan_bench_records(key: str, root: Optional[str] = None):
    """Scan BENCH_r*.json under ``root`` (repo root by default) for
    ``key``. Returns ``(values, n_files, malformed)`` where ``malformed``
    lists basenames of records that existed but could not be used
    (unreadable JSON, or not a dict) — so callers can journal a
    ``baseline_warning`` instead of silently training unbaselined.

    The key is looked up in the record's ``parsed`` dict first, then at
    the top level — quality summary keys (e.g. ``quality_comp_err``)
    land wherever bench.py's ``_record`` copied them."""
    root = root or _REPO_ROOT
    values: List[float] = []
    malformed: List[str] = []
    paths = sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))
    for path in paths:
        try:
            with open(path) as f:
                rec = json.load(f)
            if not isinstance(rec, dict):
                malformed.append(os.path.basename(path))
                continue
            parsed = rec.get("parsed")
            val = (parsed or {}).get(key) if isinstance(parsed, dict) \
                else None
            if val is None:
                val = rec.get(key)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                values.append(float(val))
        except Exception:
            malformed.append(os.path.basename(path))
    return values, len(paths), malformed


def load_bench_values(key: str,
                      root: Optional[str] = None) -> List[float]:
    """All usable ``key`` values from BENCH_r*.json under ``root``
    (repo root by default). Tolerates missing/garbled records."""
    return scan_bench_records(key, root=root)[0]


class RegressionDetector:
    """Flags step times above ``tolerance × baseline_ms``."""

    def __init__(self, baseline_ms: Optional[float],
                 tolerance: float = 1.5, warmup_windows: int = 2,
                 bus=None, key: Optional[str] = None,
                 quality_limits: Optional[Dict[str, float]] = None,
                 phase_limits: Optional[Dict[str, float]] = None):
        self.baseline_ms = baseline_ms
        self.tolerance = float(tolerance)
        self.warmup_windows = int(warmup_windows)
        self.bus = bus
        self.key = key
        self.quality_limits = dict(quality_limits or {})
        self.phase_limits = dict(phase_limits or {})
        self.observations = 0
        self.flagged: List[Dict[str, Any]] = []

    @classmethod
    def from_bench_records(cls, key: str = "oktopk_ms",
                           root: Optional[str] = None,
                           **kwargs) -> "RegressionDetector":
        vals, n_files, malformed = scan_bench_records(key, root=root)
        baseline = statistics.median(vals) if vals else None
        det = cls(baseline, key=key, **kwargs)
        if baseline is None and det.bus is not None:
            # an unusable baseline must not kill training (the detector
            # is advisory) — but it must not vanish silently either
            reason = ("no BENCH records" if n_files == 0
                      else f"no usable '{key}' value in {n_files} records")
            det.bus.emit("baseline_warning", step=0, key=str(key),
                         reason=reason, files=n_files,
                         malformed=list(malformed))
        return det

    def observe(self, step: int, ms: float) -> Optional[Dict[str, Any]]:
        """Feed one measured step time (milliseconds). Returns the
        regression record when flagged, else None."""
        self.observations += 1
        if self.baseline_ms is None or self.baseline_ms <= 0:
            return None
        if self.observations <= self.warmup_windows:
            return None
        ms = float(ms)
        if ms <= self.tolerance * self.baseline_ms:
            return None
        rec = {"step": int(step), "ms": ms,
               "baseline_ms": float(self.baseline_ms),
               "ratio": ms / self.baseline_ms,
               "tolerance": self.tolerance, "key": self.key}
        self.flagged.append(rec)
        if self.bus is not None:
            self.bus.emit("regression", **rec)
        return rec

    def observe_quality(self, step: int,
                        summary: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Check a quality summary (e.g. a rollup's fields) against the
        configured ``quality_limits`` (``{"comp_err_mean": 0.5, ...}``).
        Each exceeded limit is journalled as a ``regression`` event with
        ``key="quality:<field>"`` — the same event the feedback window
        votes on, so fidelity drift can force a re-tune exactly like a
        step-time regression. No warmup gating: quality values are not
        compile-time-polluted."""
        flagged: List[Dict[str, Any]] = []
        for field, limit in self.quality_limits.items():
            val = summary.get(field)
            if not isinstance(val, (int, float)) or limit <= 0:
                continue
            val = float(val)
            if val != val or val <= float(limit):   # NaN or within limit
                continue
            rec = {"step": int(step), "ms": val,
                   "baseline_ms": float(limit), "ratio": val / float(limit),
                   "tolerance": 1.0, "key": f"quality:{field}"}
            flagged.append(rec)
            self.flagged.append(rec)
            if self.bus is not None:
                self.bus.emit("regression", **rec)
        return flagged

    def observe_phases(self, step: int,
                       phases: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Check per-phase durations against ``phase_limits``
        (``{"exchange": 50.0, ...}``, milliseconds). ``phases`` maps
        phase name to a plain ms number OR a stats dict (a PhaseTimers
        summary entry or a step_anatomy phase entry) — ``ms`` then
        ``mean_ms`` is read from it. Each exceeded limit journals a
        ``regression`` with ``key="phase:<name>"``, the same event the
        retune feedback window votes on. No warmup gating: the caller
        feeds post-compile summaries."""
        flagged: List[Dict[str, Any]] = []
        for name, limit in self.phase_limits.items():
            val = phases.get(name)
            if isinstance(val, dict):
                val = val.get("ms", val.get("mean_ms"))
            if not isinstance(val, (int, float)) or isinstance(val, bool) \
                    or float(limit) <= 0:
                continue
            val = float(val)
            if val != val or val <= float(limit):   # NaN or within limit
                continue
            rec = {"step": int(step), "ms": val,
                   "baseline_ms": float(limit), "ratio": val / float(limit),
                   "tolerance": 1.0, "key": f"phase:{name}"}
            flagged.append(rec)
            self.flagged.append(rec)
            if self.bus is not None:
                self.bus.emit("regression", **rec)
        return flagged
