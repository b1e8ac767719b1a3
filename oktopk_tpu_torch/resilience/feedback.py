"""Fault→autotune feedback: sustained degradation forces a re-tune.

Counterpart of ``oktopk_tpu/resilience/feedback.py`` (``AutotuneFeedback``
:30), copied, with one method of its own: ``note_peer_fire``, the
bookkeeping of a firing that another rank's vote decided (below).

The autotuner calibrates the fabric once and re-tunes on a *step
cadence*; the detectors see what actually changed. This policy closes
the gap "On the Utility of Gradient Compression" (arXiv 2103.00543)
warns about — a statically tuned plan stops paying the moment conditions
drift. It subscribes to the run journal's bus and, when a sustained
stream of ``regression`` events (or guard strikes) lands inside a short
window, tells the trainer to drop its
:class:`~oktopk_tpu_torch.autotune.Autotuner` entirely. A fresh tuner
has ``coeffs=None``, so the next ``tune()`` re-probes the (now degraded)
fabric before re-deciding — the path ``Trainer.resize_workers`` takes
after an elastic resize.

The causal chain lands in the journal as linked events:
``fault_seen`` → ``regression``/``guard_trip`` (the evidence) →
``retune`` (this policy firing, carrying the evidence steps) →
``calibration`` (the forced re-probe) → ``autotune_decision`` (the new
plan).

Across processes each rank's bus sees its own evidence, and the
Trainer agrees on the vote (``Trainer.check_feedback``: one small psum
of the ranks that fired): when any rank fires, every rank re-tunes, and
a rank whose own vote did not pass takes the same bookkeeping
(``note_peer_fire``: its evidence consumed, its cooldown started), so
the ranks' windows stay in step.

Host-side and event-driven: a run without faults never pays more than a
list append per flagged event.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple


class AutotuneFeedback:
    """Sliding-window vote over degradation events on the obs bus.

    Fires (returns a trigger descriptor from :meth:`should_retune`) when
    at least ``min_signals`` matching events landed within the last
    ``window_steps`` steps, then backs off for ``cooldown_steps`` so one
    incident cannot thrash the tuner with re-plans — re-tuning is
    expensive (calibration probes + candidate trials), so the evidence
    bar is deliberately higher than the guard's single-step trip.
    """

    def __init__(self, bus=None, window_steps: int = 32,
                 min_signals: int = 3, cooldown_steps: int = 64,
                 kinds: Sequence[str] = ("regression", "guard_trip")):
        self.window_steps = max(1, int(window_steps))
        self.min_signals = max(1, int(min_signals))
        self.cooldown_steps = max(0, int(cooldown_steps))
        self.kinds = tuple(kinds)
        self.signals: List[Tuple[int, str]] = []   # (step, event kind)
        self.fired = 0
        self._cooldown_until = -1
        if bus is not None:
            bus.subscribe(self._on_event)

    # Bus subscriber — must never raise (the bus swallows subscriber
    # failures into its dropped counter, but a silent drop here would
    # lose evidence without a trace).
    def _on_event(self, entry: Dict[str, Any]) -> None:
        if entry.get("event") not in self.kinds:
            return
        if (entry.get("event") == "quality_rollup"
                and not entry.get("breaches")):
            return       # clean fidelity windows are not degradation
        step = entry.get("step")
        if isinstance(step, (int, float)):
            self.signals.append((int(step), str(entry["event"])))

    def should_retune(self, step: int) -> Optional[Dict[str, Any]]:
        """Poll at host step ``step``; consume the evidence and return a
        ``{"trigger": kind, "signals": [steps...]}`` descriptor when the
        window vote passes, else None."""
        step = int(step)
        # stale evidence ages out regardless of cooldown
        self.signals = [(s, k) for s, k in self.signals
                        if step - s < self.window_steps]
        if step < self._cooldown_until:
            return None
        if len(self.signals) < self.min_signals:
            return None
        recent = list(self.signals)
        self.note_peer_fire(step)
        return {"trigger": recent[-1][1],
                "signals": [s for s, _ in recent]}

    def note_peer_fire(self, step: int) -> None:
        """Record a firing at host step ``step``: the evidence is
        consumed and the cooldown starts (``should_retune``'s own
        bookkeeping, taken alone by a rank that re-tunes on another
        rank's vote)."""
        self.signals = []
        self.fired += 1
        self._cooldown_until = int(step) + self.cooldown_steps
