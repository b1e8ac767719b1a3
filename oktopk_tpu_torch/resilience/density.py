"""Guard-aware density backoff: retreat the schedule under guard pressure.

Counterpart of ``oktopk_tpu/resilience/density.py``, line for line (pure
Python).

A ``density_schedule`` marches density upward on a fixed step schedule,
oblivious to what the guard is seeing. When reduced-gradient magnitudes
repeatedly crowd the guard's ``abs_limit`` (or trip it outright), every
additional selected coordinate is another near-absurd value delivered
into the optimizer and another poisoned entry in the error-feedback
residual. This controller is the closed-loop answer: after
``backoff_steps`` consecutive pressured steps it halves (``factor``) the
*effective* density — bounded by ``max_level`` — and only re-advances
one level per ``clean_streak`` consecutive clean steps, so the schedule
is hysteretic in both directions and cannot oscillate on a flapping
fault.

The scale multiplies the schedule's (or per-bucket plan's) densities
when the trainer re-plans its step; under a schedule, capacity sizing
stays pinned to ``cfg.density``, so backing off never re-sizes wire
buffers — it only shrinks k. Every level
change is journalled as a ``density_backoff`` event (direction, level,
scale, trigger), giving the run journal the full pressure/relief
timeline next to the guard trips that caused it.

Pressure is either signal the guarded step already computes:
``reduced_absmax`` entering the near band (``near_ratio * abs_limit``)
without tripping, or an outright guard skip. Host-side, plain ints — no
device work, no re-plan except at an actual level change.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class DensityBackoff:
    """Hysteretic level controller over guard pressure.

    ``observe`` returns None on no change, or a journal-ready dict
    ``{"direction": "backoff"|"advance", "level": int, "scale": float,
    "trigger": str}`` when the level moved (the caller applies
    ``scale`` to its densities and rebuilds the step).
    """

    def __init__(self, abs_limit: float, near_ratio: float = 0.1,
                 backoff_steps: int = 3, factor: float = 0.5,
                 max_level: int = 3, clean_streak: int = 8):
        if not (0.0 < factor < 1.0):
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        for name, val in (("backoff_steps", backoff_steps),
                          ("max_level", max_level),
                          ("clean_streak", clean_streak)):
            if int(val) < 1:
                raise ValueError(f"{name} must be >= 1, got {val}")
        self.abs_limit = float(abs_limit)
        self.near_ratio = float(near_ratio)
        self.backoff_steps = int(backoff_steps)
        self.factor = float(factor)
        self.max_level = int(max_level)
        self.clean_streak = int(clean_streak)
        self.level = 0
        self._near = 0
        self._clean = 0
        self._fidelity = 0  # consecutive quality-breach signals

    @property
    def scale(self) -> float:
        return self.factor ** self.level

    def observe(self, step: int, absmax: float = 0.0,
                skipped: int = 0) -> Optional[Dict[str, Any]]:
        """Digest one step's guard pressure; return a level change."""
        absmax = float(absmax)
        # NaN absmax means the step carried nonfinites — the skip flag is
        # the authoritative signal there (NaN comparisons are False).
        near = bool(skipped) or (absmax == absmax
                                 and absmax > self.near_ratio * self.abs_limit)
        if near:
            self._near += 1
            self._clean = 0
            if self._near >= self.backoff_steps and self.level < self.max_level:
                self.level += 1
                self._near = 0
                return {"direction": "backoff", "level": self.level,
                        "scale": self.scale,
                        "trigger": "guard_skip" if skipped else "near_abs_limit"}
        else:
            self._clean += 1
            self._near = 0
            if self._clean >= self.clean_streak and self.level > 0:
                self.level -= 1
                self._clean = 0
                return {"direction": "advance", "level": self.level,
                        "scale": self.scale, "trigger": "clean_streak"}
        return None

    def note_quality_breach(self, step: int,
                            kind: str) -> Optional[Dict[str, Any]]:
        """Digest one fidelity breach from a ``quality_rollup`` — the
        other half of the closed loop. Guard pressure pushes the level
        DOWN (less density); sustained residual-growth / compression-
        error breaches mean the compressed stream is no longer carrying
        the gradient, so after ``backoff_steps`` such signals the level
        advances back UP one notch (more density). Breach kinds that
        argue for LESS density (``churn_spike``, ``density_collapse``)
        are deliberately not counted here: churn is a selection-
        stability symptom and collapse is a downstream effect of this
        very controller. Same journal-ready return contract as
        :meth:`observe`."""
        if kind not in ("residual_growth", "comp_err"):
            return None
        self._fidelity += 1
        if self._fidelity >= self.backoff_steps and self.level > 0:
            self.level -= 1
            self._fidelity = 0
            self._clean = 0
            return {"direction": "advance", "level": self.level,
                    "scale": self.scale, "trigger": "quality_breach"}
        return None
