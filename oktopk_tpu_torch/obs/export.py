"""Prometheus-textfile export of the quality + anatomy telemetry planes.

Counterpart of ``oktopk_tpu/obs/export.py`` (``_render_anatomy`` :58,
``render_prometheus`` :97, ``write_textfile`` :142), copied, so the same
journal renders to the same bytes. Renders the LATEST ``quality_rollup``
per bucket (plus run-level counters) and the latest step-anatomy
attribution (``step_anatomy``, ``overlap_report``; read only) in the
node-exporter textfile-collector format. Gauges carry ``bucket`` and
``algo`` labels (anatomy phases add ``phase``/``lane``); every
exposition is self-describing (# HELP / # TYPE) and deterministic in
ordering.
"""


from __future__ import annotations

import math
import os
from typing import Any, Dict, List

_PREFIX = "oktopk_quality"

# rollup field -> (metric suffix, help text)
_GAUGES = (
    ("comp_err_mean", "compression error ||g_hat-g||^2/||g||^2, window mean"),
    ("comp_err_max", "compression error, window max"),
    ("res_norm_mean", "error-feedback residual L2 norm, window mean"),
    ("res_growth_mean", "step-over-step residual growth ratio, window mean"),
    ("eff_density_mean", "realised selection density k_hat/n, window mean"),
    ("eff_density_min", "realised selection density, window min"),
    ("thr_drift_mean", "predicted/exact threshold ratio, window mean"),
    ("churn_mean", "step-over-step winner-index churn, window mean"),
)


def _esc(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


_ANATOMY_PREFIX = "oktopk_anatomy"

# overlap_report field -> (gauge suffix == field, help text)
_OVERLAP_GAUGES = (
    ("overlap_ratio", "fraction of collective time hidden under compute "
                      "(overlap_ms / comm_ms)"),
    ("compute_ms", "union of compute-lane time in the captured step"),
    ("comm_ms", "union of collective-lane time in the captured step"),
    ("overlap_ms", "compute/collective lane intersection"),
    ("step_ms", "measured captured-step span"),
    ("ideal_ms", "fully-overlapped lower bound max(compute, comm)"),
    ("serialization_ms", "measured span above the ideal lower bound"),
)


def _render_anatomy(entries: List[Dict[str, Any]]) -> List[str]:
    """Gauge lines for the newest step_anatomy (per bucket) and
    overlap_report events; [] when the journal carries neither."""
    latest_anat: Dict[int, Dict[str, Any]] = {}
    latest_overlap: Dict[str, Any] = {}
    for e in entries:
        if e.get("event") == "step_anatomy":
            latest_anat[int(e.get("bucket", 0))] = e
        elif e.get("event") == "overlap_report":
            latest_overlap = e
    lines: List[str] = []
    name = f"{_ANATOMY_PREFIX}_phase_ms"
    samples = []
    for b in sorted(latest_anat):
        phases = latest_anat[b].get("phases")
        if not isinstance(phases, dict):
            continue
        for ph in sorted(phases):
            d = phases[ph] if isinstance(phases[ph], dict) else {}
            v = d.get("ms", phases[ph])
            if isinstance(v, (int, float)) and math.isfinite(float(v)):
                labels = (f'bucket="{b}",phase="{_esc(ph)}",'
                          f'lane="{_esc(d.get("lane", "compute"))}"')
                samples.append(f"{name}{{{labels}}} {float(v):.10g}")
    if samples:
        lines.append(f"# HELP {name} per-phase attributed device/probe "
                     "time from the latest step-anatomy capture")
        lines.append(f"# TYPE {name} gauge")
        lines.extend(samples)
    for field, help_text in _OVERLAP_GAUGES:
        v = latest_overlap.get(field)
        if isinstance(v, (int, float)) and math.isfinite(float(v)):
            name = f"{_ANATOMY_PREFIX}_{field}"
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(v):.10g}")
    return lines


def render_prometheus(entries: List[Dict[str, Any]]) -> str:
    """Prometheus exposition text from a journal's entries."""
    latest: Dict[int, Dict[str, Any]] = {}
    breaches: Dict[int, int] = {}
    for e in entries:
        if e.get("event") != "quality_rollup":
            continue
        b = int(e.get("bucket", 0))
        latest[b] = e
        breaches[b] = breaches.get(b, 0) + len(e.get("breaches") or [])
    lines: List[str] = []
    for field, help_text in _GAUGES:
        name = f"{_PREFIX}_{field}"
        samples = []
        for b in sorted(latest):
            v = latest[b].get(field)
            if isinstance(v, (int, float)) and math.isfinite(float(v)):
                labels = (f'bucket="{b}",'
                          f'algo="{_esc(latest[b].get("algo", "?"))}"')
                samples.append(f"{name}{{{labels}}} {float(v):.10g}")
        if samples:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            lines.extend(samples)
    if latest:
        name = f"{_PREFIX}_breaches_total"
        lines.append(f"# HELP {name} fidelity breaches flagged across "
                     "the run's rollups")
        lines.append(f"# TYPE {name} counter")
        for b in sorted(latest):
            labels = (f'bucket="{b}",'
                      f'algo="{_esc(latest[b].get("algo", "?"))}"')
            lines.append(f"{name}{{{labels}}} {breaches.get(b, 0)}")
        name = f"{_PREFIX}_last_step"
        lines.append(f"# HELP {name} journal step of the newest rollup")
        lines.append(f"# TYPE {name} gauge")
        for b in sorted(latest):
            labels = (f'bucket="{b}",'
                      f'algo="{_esc(latest[b].get("algo", "?"))}"')
            lines.append(f"{name}{{{labels}}} "
                         f"{int(latest[b].get('step', 0))}")
    lines.extend(_render_anatomy(entries))
    return "\n".join(lines) + ("\n" if lines else "")


def write_textfile(entries: List[Dict[str, Any]], path: str) -> str:
    """Atomic write (tmp -> rename) — the textfile collector must
    never scrape a torn exposition."""
    text = render_prometheus(entries)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path
