"""Windowed quality rollups + breach detection on the run-journal bus.

Counterpart of ``oktopk_tpu/obs/rollup.py`` (``rollup_quality_event``
:53, ``RollupEngine`` :114), copied. ``RollupEngine`` subscribes to the
bus: every per-bucket ``quality`` flush (``obs/quality.py``) is at once
aggregated into one ``quality_rollup`` event — means and extremes over
the window's samples, guard-skipped rows left out of the aggregates but
counted — with a ``breaches`` list naming the fidelity invariants that
failed:

- ``residual_growth``  — mean step-over-step residual growth above
  ``growth_limit`` with residual mass present;
- ``density_collapse`` — mean realised density below ``collapse_ratio
  ×`` the bucket's target with nonzero compression error (lossless
  windows, such as dense warmup steps, are exempt);
- ``churn_spike``      — mean index churn above ``churn_limit``;
- ``comp_err``         — mean compression error above
  ``comp_err_limit``.

The trainer builds the RunJournal before this engine, so the nested
emit lands each rollup right after its quality event in the journal.
``on_breach(step, bucket, breaches)`` is the closed-loop hook (the
trainer's ``_on_quality_breach``).
"""


from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence


def _agg(vals: Sequence[Any], fn) -> Optional[float]:
    clean = [float(v) for v in vals if isinstance(v, (int, float))]
    return fn(clean) if clean else None


def _mean(vals: Sequence[Any]) -> Optional[float]:
    return _agg(vals, lambda v: sum(v) / len(v))


def rollup_quality_event(entry: Dict[str, Any],
                         growth_limit: float = 1.5,
                         collapse_ratio: float = 0.25,
                         churn_limit: float = 0.9,
                         comp_err_limit: float = 1.0,
                         target_density: Optional[float] = None,
                         ) -> Dict[str, Any]:
    """One ``quality`` event -> one ``quality_rollup`` payload."""
    skipped = [int(s) for s in (entry.get("skipped") or [])]
    n_rows = int(entry.get("count") or len(entry.get("steps") or []))

    def live(col: str) -> List[Any]:
        vals = entry.get(col) or []
        if skipped and len(skipped) == len(vals):
            return [v for v, s in zip(vals, skipped) if not s]
        return list(vals)

    roll: Dict[str, Any] = {
        "step": int(entry.get("step", 0)),
        "bucket": int(entry.get("bucket", 0)),
        "window": n_rows, "skipped": sum(skipped),
    }
    if entry.get("algo"):
        roll["algo"] = str(entry["algo"])
    stats = {
        "comp_err_mean": _mean(live("comp_err")),
        "comp_err_max": _agg(live("comp_err"), max),
        "res_norm_mean": _mean(live("res_norm")),
        "res_norm_last": _agg(live("res_norm")[-1:], lambda v: v[0]),
        "res_growth_mean": _mean(live("res_growth")),
        "res_growth_max": _agg(live("res_growth"), max),
        "eff_density_mean": _mean(live("eff_density")),
        "eff_density_min": _agg(live("eff_density"), min),
        "thr_drift_mean": _mean(live("thr_drift")),
        "churn_mean": _mean(live("churn")),
        "churn_max": _agg(live("churn"), max),
    }
    roll.update({k: v for k, v in stats.items() if v is not None})
    if target_density is not None:
        roll["target_density"] = float(target_density)

    breaches: List[str] = []
    g = stats["res_growth_mean"]
    if (g is not None and g > growth_limit
            and (stats["res_norm_mean"] or 0.0) > 0.0):
        breaches.append("residual_growth")
    d = stats["eff_density_mean"]
    if (d is not None and target_density is not None
            and target_density > 0 and d < collapse_ratio * target_density
            and (stats["comp_err_mean"] or 0.0) > 1e-6):
        breaches.append("density_collapse")
    c = stats["churn_mean"]
    if c is not None and c > churn_limit:
        breaches.append("churn_spike")
    e = stats["comp_err_mean"]
    if e is not None and e > comp_err_limit:
        breaches.append("comp_err")
    roll["breaches"] = breaches
    return roll


class RollupEngine:
    """Bus subscriber: quality flush in, windowed rollup out.

    ``target_densities`` (per-bucket, kept current by the trainer at
    flush time) anchors density-collapse detection; ``on_breach(step,
    bucket, breaches)`` is the closed-loop hook. A subscriber must
    never raise — the bus swallows failures, but evidence would be
    lost silently — so aggregation is defensive about missing fields.
    """

    def __init__(self, bus, growth_limit: float = 1.5,
                 collapse_ratio: float = 0.25, churn_limit: float = 0.9,
                 comp_err_limit: float = 1.0,
                 on_breach: Optional[Callable[[int, int, List[str]],
                                              Any]] = None):
        self.bus = bus
        self.growth_limit = float(growth_limit)
        self.collapse_ratio = float(collapse_ratio)
        self.churn_limit = float(churn_limit)
        self.comp_err_limit = float(comp_err_limit)
        self.on_breach = on_breach
        self.target_densities: List[float] = []
        self.rollups: List[Dict[str, Any]] = []
        self.breached = 0
        if bus is not None:
            bus.subscribe(self._on_event)

    def _target_for(self, bucket: int) -> Optional[float]:
        if 0 <= bucket < len(self.target_densities):
            return float(self.target_densities[bucket])
        return None

    def _on_event(self, entry: Dict[str, Any]) -> None:
        if entry.get("event") != "quality":
            return
        roll = rollup_quality_event(
            entry, growth_limit=self.growth_limit,
            collapse_ratio=self.collapse_ratio,
            churn_limit=self.churn_limit,
            comp_err_limit=self.comp_err_limit,
            target_density=self._target_for(int(entry.get("bucket", 0))))
        self.rollups.append(roll)
        if self.bus is not None:
            # nested emit: EventBus iterates a snapshot of subscribers,
            # so re-entrant emission is safe and the rollup journals
            # directly after the quality event that produced it
            self.bus.emit("quality_rollup", **roll)
        if roll["breaches"]:
            self.breached += 1
            if self.on_breach is not None:
                self.on_breach(roll["step"], roll["bucket"],
                               list(roll["breaches"]))
