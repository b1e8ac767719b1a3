"""Host-side escalation policy: strikes -> dense fallback -> restore.

Counterpart of ``oktopk_tpu/resilience/supervisor.py``, line for line
(pure Python: the same actions and the same ``to_state`` keys, so a
checkpoint's ``extra`` payload resumes in either package).

The in-step guard (``resilience/guard.py``) makes a single bad step
harmless; the supervisor handles *persistent* degradation, which a pure
in-step mechanism cannot (a corrupted link corrupts every retry). The
escalation ladder, mirroring SparCML's sparse/dense switching
(arXiv 1802.08021) applied to fault handling instead of performance:

1. **observe** — after each step (on the trainer's check cadence) the
   supervisor reads the guard's metrics: which buckets tripped, whether
   the step was skipped.
2. **strike** — per-bucket strike counters accumulate across trips (a
   clean step decays them by one rather than resetting: intermittent
   corruption must still escalate); a consecutive-skip counter tracks
   run-level divergence.
3. **fallback** — after ``max_strikes`` on a bucket, that bucket's plan
   flips to ``dense`` (the trainer re-plans its step,
   ``SparseGradStep.replan``). Dense psum has no sparse payload to
   corrupt at the wire seam and no residual to poison — it is the safe
   degraded mode, at 2n volume cost for that bucket only.
4. **restore** — ``divergence_limit`` consecutive skips mean the run is
   not making progress (e.g. params already poisoned before the guard
   was enabled, or every bucket degraded): restore from the last good
   checkpoint registered via :meth:`note_checkpoint`.
5. **remesh** — a chip loss (:meth:`note_chip_loss`, fed by the host
   orchestrator seam ``faults.dead_workers``) is not evidence to weigh:
   the rank is gone. It bypasses strikes *and* the cooldown and emits a
   ``remesh`` action immediately; the trainer executes it via
   ``Trainer.resize_workers`` onto the surviving devices, carrying
   params/opt state and this supervisor's counters across the resize so
   training resumes without a requeue.

After any evidence-based escalation the supervisor backs off for
``cooldown_steps`` before escalating again, so one burst of faults
cannot cascade a fallback AND a restore from the same evidence.

All state is plain Python ints/lists (:meth:`to_state` /
:meth:`load_state`) so it checkpoints alongside the train state and a
resumed run keeps its strike counters and active fallbacks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from oktopk_tpu_torch.resilience.journal import HealthJournal


@dataclasses.dataclass(frozen=True)
class Action:
    """One escalation decision for the trainer to execute."""

    kind: str                    # "fallback" | "restore" | "remesh"
    bucket: int = -1             # fallback target (-1 otherwise)
    ckpt: Optional[str] = None   # restore source (None = unavailable)
    workers: tuple = ()          # remesh: ranks to drop from the mesh


class Supervisor:
    """Per-run escalation state machine (host-side)."""

    def __init__(self, num_buckets: int = 1, max_strikes: int = 3,
                 divergence_limit: int = 8, cooldown_steps: int = 0,
                 journal: Optional[HealthJournal] = None):
        self.num_buckets = max(1, int(num_buckets))
        self.max_strikes = max(1, int(max_strikes))
        self.divergence_limit = max(1, int(divergence_limit))
        self.cooldown_steps = max(0, int(cooldown_steps))
        self.journal = journal if journal is not None else HealthJournal()
        self.strikes = [0] * self.num_buckets
        self.consecutive_skips = 0
        self.forced_dense: List[int] = []
        self.last_good_step = -1
        self.last_good_ckpt: Optional[str] = None
        self.fallback_events = 0
        self.restore_events = 0
        self.remesh_events = 0
        self.ckpt_write_failures = 0
        self.dead_workers: List[int] = []
        self._cooldown_until = -1

    # ---- inputs -------------------------------------------------------

    def note_checkpoint(self, path: str, step: int) -> None:
        """Register a checkpoint as a restore candidate. Only checkpoints
        taken while the run is healthy qualify — restoring into a
        snapshot saved mid-incident would replay the divergence. Every
        checkpoint is journalled either way, with the ``qualified`` flag
        saying whether it became a restore target."""
        qualified = self.consecutive_skips == 0
        if qualified:
            self.last_good_ckpt = path
            self.last_good_step = int(step)
        self.journal.record("checkpoint", step=int(step), path=path,
                            qualified=qualified)

    def note_chip_loss(self, step: int, workers: Sequence[int]
                       ) -> List[Action]:
        """Record permanently dead ranks; emit a ``remesh`` action for any
        newly observed ones. Idempotent per worker — the trainer can call
        this every supervision cadence with the cumulative dead set. A
        dead chip is a fact, not evidence: no strikes, no cooldown."""
        step = int(step)
        newly = [int(w) for w in workers
                 if int(w) not in self.dead_workers]
        if not newly:
            return []
        self.dead_workers.extend(newly)
        self.remesh_events += 1
        self.journal.fault_seen(step, "chip_loss", workers=newly)
        return [Action("remesh", workers=tuple(newly))]

    def observe(self, step: int, metrics: Dict[str, Any]) -> List[Action]:
        """Digest one step's guard metrics; return escalation actions.

        ``metrics`` needs ``step_skipped`` (0/1) and ``bucket_anomalies``
        (i32[num_buckets] trip flags) — both emitted by the guarded step.
        """
        step = int(step)
        skipped = bool(int(np.asarray(metrics.get("step_skipped", 0))))
        flags = np.asarray(metrics.get(
            "bucket_anomalies", np.zeros(self.num_buckets, np.int32)))
        actions: List[Action] = []
        if skipped:
            self.consecutive_skips += 1
            tripped = [b for b in range(self.num_buckets)
                       if b < flags.size and flags[b]]
            for b in tripped:
                self.strikes[b] += 1
            self.journal.guard_trip(step, tripped, self.consecutive_skips,
                                    self.strikes)
        else:
            self.consecutive_skips = 0
            if self.last_good_step < step:
                self.last_good_step = step
            # decay, don't reset: an every-other-step fault must escalate
            self.strikes = [max(0, s - 1) for s in self.strikes]

        for b in range(self.num_buckets):
            if (self.strikes[b] >= self.max_strikes
                    and b not in self.forced_dense
                    and step >= self._cooldown_until):
                self.forced_dense.append(b)
                self.fallback_events += 1
                self.journal.fallback(step, b, "dense", self.strikes[b])
                actions.append(Action("fallback", bucket=b))
                self._cooldown_until = step + self.cooldown_steps

        if (self.consecutive_skips >= self.divergence_limit
                and step >= self._cooldown_until):
            self.restore_events += 1
            if self.last_good_ckpt is None:
                # nothing to verify or execute: journal right here
                self.journal.restore(step, None, self.last_good_step)
            # a successful restore is journalled by the trainer AFTER
            # checkpoint verification, so ckpt_verify_failed events for
            # a corrupt target precede the restore record and the
            # journal names the file actually loaded, not the intended
            # one (train/durable.py verified_restore)
            actions.append(Action("restore", ckpt=self.last_good_ckpt))
            # the restore (or its unavailability) consumed this evidence
            self.consecutive_skips = 0
            self._cooldown_until = step + self.cooldown_steps
        return actions

    def note_ckpt_write_failure(self, step: int, path: str,
                                error: Any) -> None:
        """An async (or sync) checkpoint save failed to write or verify.
        The writer (``durable.AsyncCheckpointer``) already journalled the
        ``ckpt_verify_failed``; here the failure is *counted* and — if
        the failed file was the registered restore target — the
        registration is dropped, so a later divergence restore falls
        back to the previous good checkpoint instead of chasing a file
        that never published."""
        del error  # journalled by the writer
        self.ckpt_write_failures += 1
        if self.last_good_ckpt == path:
            self.last_good_ckpt = None
            self.last_good_step = -1

    # ---- checkpointable state ----------------------------------------

    def to_state(self) -> Dict[str, Any]:
        """Plain-scalar state for the checkpoint ``extra`` payload."""
        return {
            "strikes": [int(s) for s in self.strikes],
            "consecutive_skips": int(self.consecutive_skips),
            "forced_dense": [int(b) for b in self.forced_dense],
            "last_good_step": int(self.last_good_step),
            "last_good_ckpt": self.last_good_ckpt or "",
            "fallback_events": int(self.fallback_events),
            "restore_events": int(self.restore_events),
            "remesh_events": int(self.remesh_events),
            "ckpt_write_failures": int(self.ckpt_write_failures),
            "dead_workers": [int(w) for w in self.dead_workers],
            "cooldown_until": int(self._cooldown_until),
        }

    def load_state(self, state: Dict[str, Any]) -> "Supervisor":
        """Restore counters/fallbacks saved by :meth:`to_state` (tolerant
        of missing keys, like the checkpoint field merge)."""
        if not state:
            return self
        strikes = [int(s) for s in np.asarray(
            state.get("strikes", self.strikes)).tolist()]
        # bucket count changes (replan) keep the overlapping prefix
        self.strikes = (strikes + [0] * self.num_buckets)[:self.num_buckets]
        self.consecutive_skips = int(state.get("consecutive_skips", 0))
        self.forced_dense = sorted(
            int(b) for b in np.asarray(
                state.get("forced_dense", [])).reshape(-1).tolist()
            if 0 <= int(b) < self.num_buckets)
        self.last_good_step = int(state.get("last_good_step", -1))
        ck = state.get("last_good_ckpt", "")
        if isinstance(ck, bytes):
            ck = ck.decode()
        self.last_good_ckpt = str(ck) or None
        self.fallback_events = int(state.get("fallback_events", 0))
        self.restore_events = int(state.get("restore_events", 0))
        self.remesh_events = int(state.get("remesh_events", 0))
        self.ckpt_write_failures = int(state.get("ckpt_write_failures", 0))
        self.dead_workers = [int(w) for w in np.asarray(
            state.get("dead_workers", [])).reshape(-1).tolist()]
        self._cooldown_until = int(state.get("cooldown_until", -1))
        return self


def plan_with_fallbacks(names: Sequence[str], forced_dense: Sequence[int]
                        ) -> List[str]:
    """Apply the supervisor's forced-dense set to a per-bucket algorithm
    plan (autotuned or uniform) — the single place the escalation ladder
    rewrites a plan, so autotune re-tunes cannot silently resurrect a
    quarantined bucket's sparse collective."""
    out = list(names)
    for b in forced_dense:
        if 0 <= b < len(out):
            out[b] = "dense"
    return out
