"""Deterministic chaos drills: scripted incidents, asserted recoveries.

Counterpart of ``oktopk_tpu/resilience/drills.py`` on the port's Trainer
over a ``StackedComm`` of ``workers`` stacked workers (where JAX's runs
on a mesh). Each drill runs one incident end to end — real steps, real
collectives, a deterministic :class:`~.faults.FaultPlan` — and checks
both the training outcome (state carried bit-identically, losses
finite, no divergence) and the journalled timeline (the run journal
validates and carries the causal chain in order).

The catalog (``DRILLS``) names the same four drills as JAX's, and
``scripts/port_chaos_drill.py`` is its command line:

- ``chip_loss``       — a worker dies mid-run; the supervisor escalates
  to ``remesh`` and training resumes on the shrunk comm without a
  requeue (chain: ``fault_seen(chip_loss)`` → ``remesh`` → first
  post-resize ``step``);
- ``latency_retune``  — a sustained latency fault degrades step time;
  the feedback policy forces a re-calibrate + re-tune and the plan
  flips to the algorithm that tolerates the degraded fabric (chain:
  ``regression``... → ``retune`` → ``calibration`` →
  ``autotune_decision``), through the autotuner's fake-timing seam;
- ``density_backoff`` — repeated guard-pressure steps back the
  effective density off hysteretically, then a clean streak re-advances
  it; the same fault without the guard diverges (the contrast case);
- ``ckpt_corruption`` — the supervisor's restore target is damaged at
  rest (truncate / bitflip / torn); the divergence-triggered restore
  falls back to the older *verified* checkpoint bit-identically, with
  ``ckpt_verify_failed`` preceding ``restore`` in the journal — plus the
  async-save drain and legacy (manifest-less) checkpoint contracts of
  ``train/durable.py``.

The drills build their Trainers on ``device`` (CUDA unless the caller
asks for the CPU), with the model ``DEFAULT_DNN`` and JAX's drill
settings: warmup off, every recompute cadence 1, the journal and the
guard on (``latency_retune``: the autotuner and its feedback loop on,
the guard off, as JAX's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from oktopk_tpu_torch.resilience.faults import (FaultPlan, FaultSpec,
                                               latency_ms)

DEFAULT_DNN = "mnistnet"


@dataclasses.dataclass
class DrillReport:
    """Outcome of one drill: named checks + the journal that proves it."""

    name: str
    checks: List[Tuple[str, bool, str]]   # (check, passed, detail)
    journal: List[Dict[str, Any]]
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(passed for _, passed, _ in self.checks)

    def failed(self) -> List[str]:
        return [f"{name}: {detail}" for name, passed, detail in self.checks
                if not passed]

    def summary(self) -> str:
        lines = [f"drill {self.name}: {'PASS' if self.ok else 'FAIL'}"]
        for name, passed, detail in self.checks:
            mark = "ok" if passed else "FAIL"
            lines.append(f"  [{mark:4s}] {name}" + (f" — {detail}"
                                                    if detail else ""))
        for k, v in self.notes.items():
            lines.append(f"  note {k}: {v}")
        return "\n".join(lines)


def _check(checks: List[Tuple[str, bool, str]], name: str, passed: bool,
           detail: str = "") -> None:
    checks.append((name, bool(passed), detail))


def _drill_trainer(workers: int, device=None,
                   fault_plan: Optional[FaultPlan] = None,
                   algo_over: Optional[Dict[str, Any]] = None, **cfg_over):
    """A small, fully-instrumented trainer: ``DEFAULT_DNN`` + oktopk on
    ``workers`` stacked workers with warmup off and every recompute
    cadence at 1 (the resilience tests' setpoints), the journal and the
    guard on unless overridden."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer

    kw: Dict[str, Any] = dict(
        dnn=DEFAULT_DNN, dataset="mnist", batch_size=8, lr=0.05,
        compressor="oktopk", density=0.05, num_buckets=1,
        num_workers=workers, resilience=True, resilience_cooldown=0,
        obs=True)
    kw.update(cfg_over)
    acfg = OkTopkConfig(warmup_steps=0, local_recompute_every=1,
                        global_recompute_every=1, repartition_every=1,
                        **(algo_over or {}))
    return Trainer(TrainConfig(**kw), algo_cfg=acfg, warmup=False,
                   device=device, fault_plan=fault_plan)


def _batches(dnn: str, batch_size: int, seed: int = 9):
    from oktopk_tpu_torch.data import synthetic_batch

    rng = np.random.RandomState(seed)
    while True:
        yield synthetic_batch(dnn, batch_size, rng)


def _host_leaves(tree) -> List[np.ndarray]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _host_leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


def _leaves_equal(a, b) -> bool:
    fa, fb = _host_leaves(a), _host_leaves(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and np.array_equal(x, y, equal_nan=True)
        for x, y in zip(fa, fb))


def _params(tr) -> List[torch.Tensor]:
    return [p.detach().clone() for p in tr.params]


def _event_indices(journal, event: str, **match):
    out = []
    for i, e in enumerate(journal):
        if e.get("event") != event:
            continue
        if all(e.get(k) == v for k, v in match.items()):
            out.append(i)
    return out


def _validate(checks, journal) -> None:
    from oktopk_tpu_torch.obs.events import validate_journal

    problems = validate_journal(journal)
    _check(checks, "journal_valid", not problems, "; ".join(problems[:3]))


# ---- drill: chip loss → remesh -----------------------------------------

def drill_chip_loss(workers: int = 8, steps_before: int = 3,
                    steps_after: int = 3, lose_worker: int = 5,
                    per_worker_bs: int = 2, device=None) -> DrillReport:
    """Worker ``lose_worker`` dies at step ``steps_before``; the
    supervisor must emit ``remesh``, the trainer must resume on the
    shrunk comm with params bit-identical across the resize and the loss
    trajectory continuing — no requeue, no restore."""
    P = int(workers)
    assert 0 <= lose_worker < P, "lose_worker must be a live worker"
    k = steps_before  # the supervise step at which the chip is seen dead
    plan = FaultPlan((FaultSpec("chip_loss", step=k, worker=lose_worker),))
    tr = _drill_trainer(P, device, fault_plan=plan)
    checks: List[Tuple[str, bool, str]] = []
    losses: List[float] = []
    batches_full = _batches(DEFAULT_DNN, P * per_worker_bs)
    batches_shrunk = _batches(DEFAULT_DNN, (P - 1) * per_worker_bs, seed=10)

    params_pre = params_post = None
    strikes_after_remesh = 0
    for step in range(1, steps_before + steps_after + 1):
        pre_resize = step <= k
        m = tr.train_step(next(batches_full if pre_resize
                               else batches_shrunk))
        losses.append(float(m["loss"]))
        tr.bus.emit("step", step=step, loss=losses[-1],
                    step_skipped=int(m.get("step_skipped", 0)))
        if step == k:
            params_pre = _params(tr)
            # a strike seeded right before the remesh proves the
            # supervisor's counters are carried, not reset: the step's
            # own clean observe() decays it by exactly one
            tr.supervisor.strikes[0] = 2
        tr.supervise(step, m)
        if step == k:
            params_post = _params(tr)
            strikes_after_remesh = tr.supervisor.strikes[0]

    journal = list(tr.run_journal.entries)
    _check(checks, "remesh_emitted",
           tr.supervisor.remesh_events == 1
           and len(_event_indices(journal, "remesh")) == 1,
           f"remesh_events={tr.supervisor.remesh_events}")
    rm = [journal[i] for i in _event_indices(journal, "remesh")]
    if rm:
        e = rm[0]
        _check(checks, "remesh_fields",
               e["old_world"] == P and e["new_world"] == P - 1
               and e["trigger"] == "chip_loss"
               and e["dead_workers"] == [lose_worker]
               and "health" in e["carried"]
               and "supervisor" in e["carried"],
               f"remesh event: {e}")
    else:
        _check(checks, "remesh_fields", False, "no remesh event")
    _check(checks, "world_shrunk",
           tr.cfg.num_workers == P - 1 and tr.comm.size == P - 1,
           f"num_workers={tr.cfg.num_workers}")
    _check(checks, "params_bit_identical",
           params_pre is not None and all(
               torch.equal(a, b) for a, b in zip(params_pre, params_post)),
           "params changed across resize")
    _check(checks, "loss_continuing",
           all(np.isfinite(losses)) and len(losses) == steps_before
           + steps_after,
           f"losses={losses}")
    _check(checks, "no_requeue_no_restore",
           tr.supervisor.restore_events == 0
           and not _event_indices(journal, "restore")
           and not _event_indices(journal, "restore_unavailable"),
           "restore path fired")
    _check(checks, "strikes_carried", strikes_after_remesh == 1,
           f"strikes after remesh step: {strikes_after_remesh}")
    idx_fault = _event_indices(journal, "fault_seen", kind="chip_loss")
    idx_remesh = _event_indices(journal, "remesh")
    idx_post = [i for i, e in enumerate(journal)
                if e.get("event") == "step" and e.get("step", 0) > k]
    _check(checks, "journal_chain",
           bool(idx_fault and idx_remesh and idx_post)
           and idx_fault[0] < idx_remesh[0] < idx_post[0],
           f"fault@{idx_fault} remesh@{idx_remesh} post-step@{idx_post[:1]}")
    _validate(checks, journal)
    return DrillReport("chip_loss", checks, journal,
                       notes={"losses": losses,
                              "world": f"{P}->{tr.cfg.num_workers}"})


# ---- drill: sustained latency → forced re-tune --------------------------

def drill_latency_retune(workers: int = 8, fault_step: int = 4,
                         fault_duration: int = 6,
                         fault_latency_ms: float = 40.0,
                         num_steps: int = 14, per_worker_bs: int = 2,
                         device=None) -> DrillReport:
    """A sustained latency fault inflates the sparse path's step time;
    the regression stream must trip the feedback policy, which forces a
    re-calibrate + re-tune, and the plan must flip to the algorithm that
    tolerates the degraded fabric (dense: one exchange round instead of
    the sparse path's several). Step time recovers once the fault
    clears."""
    from oktopk_tpu_torch.obs.events import validate_journal
    from oktopk_tpu_torch.obs.regress import RegressionDetector

    P = int(workers)
    plan = FaultPlan((FaultSpec("latency", step=fault_step,
                                duration=fault_duration,
                                latency_ms=fault_latency_ms),))
    tr = _drill_trainer(
        P, device, resilience=False, autotune=True,
        autotune_candidates=("dense", "oktopk"),
        resilience_feedback=True, resilience_feedback_window=16,
        resilience_feedback_signals=3,
        resilience_feedback_cooldown=100)
    baseline_ms = 10.0
    tolerance = 1.5
    tr.regress = RegressionDetector(baseline_ms=baseline_ms,
                                    tolerance=tolerance, warmup_windows=0,
                                    bus=tr.bus, key="drill_step_ms")

    # deterministic fabric model through the trial seam: the multi-round
    # sparse exchange pays the injected latency several times per step,
    # dense pays it once — so the degraded-fabric optimum flips
    base = {"dense": 8.0, "oktopk": 5.0}
    cur = {"step": 0}

    def fake(algo: str, n: int, density: float) -> float:
        mult = 1.0 if algo == "dense" else 3.0
        return base.get(algo, 6.0) + mult * latency_ms(plan, cur["step"])

    tr.autotune(step=0, fake_ms=fake)
    checks: List[Tuple[str, bool, str]] = []
    initial_algo = tr._plans[0].algo if tr._plans else "?"
    _check(checks, "initial_plan_sparse", initial_algo == "oktopk",
           f"initial plan: {initial_algo}")
    retune_at = None
    ms_trace: List[float] = []
    batches = _batches(DEFAULT_DNN, P * per_worker_bs)
    for step in range(1, num_steps + 1):
        cur["step"] = step
        m = tr.train_step(next(batches))
        # simulated wall clock: the current plan's algorithm on the
        # currently degraded fabric (same model the trial seam uses)
        algo = tr._plans[0].algo if tr._plans else "oktopk"
        mult = 1.0 if algo == "dense" else 3.0
        ms = base.get(algo, 6.0) + mult * latency_ms(plan, step)
        ms_trace.append(ms)
        tr.bus.emit("step", step=step, loss=float(m["loss"]), dt_ms=ms)
        tr.regress.observe(step, ms)
        if tr.check_feedback(step) is not None and retune_at is None:
            retune_at = step

    journal = list(tr.run_journal.entries)
    idx_reg = _event_indices(journal, "regression")
    idx_retune = _event_indices(journal, "retune")
    idx_cal = _event_indices(journal, "calibration")
    idx_dec = _event_indices(journal, "autotune_decision")
    _check(checks, "regressions_seen", len(idx_reg) >= 3,
           f"{len(idx_reg)} regression events")
    _check(checks, "retune_fired",
           tr.retune_events == 1 and len(idx_retune) == 1
           and retune_at is not None,
           f"retune_events={tr.retune_events} at step {retune_at}")
    if idx_retune:
        e = journal[idx_retune[0]]
        _check(checks, "retune_evidence",
               e["trigger"] in ("regression", "guard_trip")
               and len(e.get("signals", [])) >= 3
               and idx_reg and idx_reg[0] < idx_retune[0],
               f"retune event: {e}")
        recal = [i for i in idx_cal if i > idx_retune[0]]
        redec = [i for i, j in ((i, journal[i]) for i in idx_dec)
                 if i > idx_retune[0]
                 and j.get("chosen", {}).get("algo") == "dense"]
        _check(checks, "chain_retune_calibration_decision",
               bool(recal) and bool(redec) and recal[0] < redec[0],
               f"retune@{idx_retune[0]} cal@{recal[:1]} dense-dec@{redec[:1]}")
    else:
        _check(checks, "retune_evidence", False, "no retune event")
        _check(checks, "chain_retune_calibration_decision", False,
               "no retune event")
    final_algo = tr._plans[0].algo if tr._plans else "?"
    _check(checks, "plan_flipped_dense", final_algo == "dense",
           f"final plan: {final_algo}")
    _check(checks, "step_time_recovered",
           ms_trace[-1] <= tolerance * baseline_ms,
           f"final step {ms_trace[-1]:.1f} ms vs "
           f"threshold {tolerance * baseline_ms:.1f} ms")
    problems = validate_journal(journal)
    _check(checks, "journal_valid", not problems, "; ".join(problems[:3]))
    # the port's own: the step follows the plan it re-planned to
    _check(checks, "step_follows_plan",
           tr.grad_step.names == [p.algo for p in tr._plans],
           f"step {tr.grad_step.names}")
    return DrillReport("latency_retune", checks, journal,
                       notes={"ms_trace": ms_trace,
                              "retune_at": retune_at,
                              "plan": f"{initial_algo}->{final_algo}"})


# ---- drill: guard pressure → density backoff ----------------------------

def drill_density_backoff(workers: int = 8, clean_before: int = 3,
                          fault_duration: int = 5, scale: float = 1e8,
                          include_contrast: bool = True,
                          per_worker_bs: int = 2,
                          device=None) -> DrillReport:
    """Repeated guard-pressure steps (a finite multiplicative gradient
    blow-up tripping the ``abs_limit`` guard) must back the effective
    density off within ``backoff_steps`` pressured steps — journalled —
    and a clean streak after the fault clears must re-advance it to full
    density. The same fault with the guard off diverges (the contrast
    case)."""
    P = int(workers)
    # health.step (the fault clock) counts attempted steps from 0
    plan = FaultPlan((FaultSpec("scale_grad", step=clean_before,
                                duration=fault_duration, scale=scale),))
    backoff_steps, clean_streak, max_level = 2, 3, 2
    knobs = dict(
        resilience_abs_limit=1e3,      # scaled magnitudes trip, normal don't
        resilience_density_backoff=True,
        resilience_near_ratio=0.5,
        resilience_backoff_steps=backoff_steps,
        resilience_backoff_factor=0.5,
        resilience_backoff_max_level=max_level,
        resilience_clean_streak=clean_streak,
        # this drill is about the density loop: park the strike/restore
        # ladders so they don't consume the same evidence
        resilience_strikes=99, resilience_divergence_limit=99)
    # an actual density_schedule, so the drill proves the backoff scales
    # the schedule itself (the "guard-aware density_schedule" contract)
    sched = {"density_schedule": ((0, 0.02), (2, 0.05)), "density": 0.05}
    tr = _drill_trainer(P, device, fault_plan=plan, algo_over=sched,
                        **knobs)
    checks: List[Tuple[str, bool, str]] = []
    batches = _batches(DEFAULT_DNN, P * per_worker_bs)
    # enough clean tail to fully re-advance: max_level streaks + slack
    total = clean_before + fault_duration + clean_streak * max_level + 2
    skipped: List[int] = []
    for step in range(1, total + 1):
        m = tr.train_step(next(batches))
        skipped.append(int(m.get("step_skipped", 0)))
        tr.bus.emit(
            "step", step=step, loss=float(m["loss"]),
            step_skipped=skipped[-1],
            reduced_absmax=float(m["reduced_absmax"]))
        tr.supervise(step, m)

    journal = list(tr.run_journal.entries)
    idx_back = _event_indices(journal, "density_backoff",
                              direction="backoff")
    idx_adv = _event_indices(journal, "density_backoff",
                             direction="advance")
    backs = [journal[i] for i in idx_back]
    advs = [journal[i] for i in idx_adv]
    first_fault_step = clean_before + 1
    _check(checks, "backed_off_within_n_steps",
           bool(backs) and backs[0]["step"]
           <= first_fault_step + backoff_steps,
           f"first backoff at {backs[0]['step'] if backs else None}, "
           f"fault from {first_fault_step}")
    _check(checks, "backoff_bounded",
           len(backs) <= max_level
           and all(b["level"] <= max_level for b in backs),
           f"{len(backs)} backoffs, levels {[b['level'] for b in backs]}")
    _check(checks, "readvanced_after_clean_streak",
           len(advs) == len(backs) and tr.density_backoff.level == 0
           and tr._density_scale == 1.0,
           f"{len(advs)} advances vs {len(backs)} backoffs, "
           f"final level {tr.density_backoff.level}")
    _check(checks, "guard_contained",
           sum(skipped) == fault_duration
           and all(bool(torch.isfinite(p).all()) for p in tr.params),
           f"{sum(skipped)} skips for {fault_duration} faulted steps")
    _check(checks, "no_fallback_no_restore",
           not _event_indices(journal, "fallback")
           and not _event_indices(journal, "restore")
           and not _event_indices(journal, "restore_unavailable"),
           "strike/restore ladder fired")
    _validate(checks, journal)

    notes: Dict[str, Any] = {
        "skipped": skipped,
        "backoff_steps": [b["step"] for b in backs],
        "advance_steps": [a["step"] for a in advs]}
    if include_contrast:
        # contrast: the same fault with no guard poisons params directly
        tr2 = _drill_trainer(P, device, fault_plan=plan, algo_over=sched,
                             resilience=False, obs=False)
        b2 = _batches(DEFAULT_DNN, P * per_worker_bs)
        for _ in range(clean_before + fault_duration + 1):
            tr2.train_step(next(b2))

        def absmax(t):
            return max(float(torch.max(torch.abs(p.detach())))
                       for p in t.params)

        mx, guarded_mx = absmax(tr2), absmax(tr)
        _check(checks, "unguarded_contrast_diverges",
               not np.isfinite(mx) or mx > 1e3,
               f"unguarded param absmax {mx:.3g}")
        _check(checks, "guarded_run_sane", guarded_mx < 1e3,
               f"guarded param absmax {guarded_mx:.3g}")
        notes["unguarded_param_absmax"] = mx
        notes["guarded_param_absmax"] = guarded_mx
    return DrillReport("density_backoff", checks, journal, notes=notes)


# ---- drill: corrupt restore target → verified fallback -------------------

def drill_ckpt_corruption(workers: int = 8, per_worker_bs: int = 2,
                          kinds: Tuple[str, ...] = ("ckpt_truncate",
                                                    "ckpt_bitflip",
                                                    "ckpt_torn"),
                          ckpt_dir: Optional[str] = None,
                          device=None) -> DrillReport:
    """The storage leg of the self-healing loop: checkpoint A (older,
    good) and B (newer, the supervisor's restore target) are saved
    through the ``durable.AsyncCheckpointer``; B is then damaged at rest
    with each ``ckpt_*`` fault kind in turn while a NaN fault drives the
    run to divergence. Every divergence-triggered restore must *skip*
    corrupt B and land on A bit-identically (params, residual, health —
    the whole state tree), with the journal showing
    ``ckpt_verify_failed(B)`` before the ``restore`` record naming A. A
    restore rewinds the attempted-step clock, so the same NaN window
    re-fires after each restore — one fault spec drives all three
    corruption rounds. Also: an async save in flight is drained whole,
    an aged ``*.tmp`` remnant is swept by the checkpoint scan, and a
    legacy manifest-less checkpoint still restores (flagged, not
    rejected)."""
    import os
    import shutil
    import tempfile

    from oktopk_tpu_torch.resilience.faults import corrupt_checkpoint
    from oktopk_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                   save_checkpoint)
    from oktopk_tpu_torch.train.durable import (AsyncCheckpointer,
                                                verified_restore,
                                                verify_checkpoint)

    P = int(workers)
    div_limit = 3
    # attempted-step clock counts from 0: host steps 1..4 run attempted
    # 0..3 (clean), attempted >= 4 is the NaN window. A is saved after
    # host step 2 (clock 2), so each post-restore cycle replays 2 clean
    # steps then hits the window again.
    plan = FaultPlan((FaultSpec("nan_grad", step=4, duration=10_000),))
    tr = _drill_trainer(P, device, fault_plan=plan,
                        resilience_divergence_limit=div_limit,
                        resilience_strikes=99)
    checks: List[Tuple[str, bool, str]] = []
    own_dir = ckpt_dir is None
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="oktopk-ckpt-drill-")
    ac = AsyncCheckpointer(ckpt_dir, journal=tr.supervisor.journal,
                           on_failure=tr.note_ckpt_failure)
    batches = _batches(DEFAULT_DNN, P * per_worker_bs)
    losses: List[float] = []

    def host_step(step: int):
        m = tr.train_step(next(batches))
        losses.append(float(m["loss"]))
        tr.bus.emit("step", step=step, loss=losses[-1],
                    step_skipped=int(m.get("step_skipped", 0)))
        tr.supervise(step, m)
        return m

    try:
        step = 0
        snap_a = path_a = path_b = None
        for _ in range(4):
            step += 1
            host_step(step)
            if step in (2, 4):
                path = ac.save(tr.train_state(), step,
                               extra=tr.supervisor_extra(),
                               qualified=tr.checkpoint_qualified)
                ac.drain()
                tr.note_checkpoint(path, step)
                if step == 2:
                    path_a, snap_a = path, tr.train_state(host=True)
                else:
                    path_b = path
        _check(checks, "saves_verified",
               ac.saves == 2 and ac.write_failures == 0
               and tr.supervisor.last_good_ckpt == path_b,
               f"saves={ac.saves} failures={ac.write_failures} "
               f"target={tr.supervisor.last_good_ckpt}")
        with open(path_b, "rb") as f:
            pristine_b = f.read()
        man_b = path_b[: -len(".msgpack")] + ".manifest.json"
        with open(man_b, "rb") as f:
            pristine_man_b = f.read()

        identical: List[bool] = []
        for i, kind in enumerate(kinds):
            if i:  # re-pristine B so the next kind damages a clean file
                with open(path_b, "wb") as f:
                    f.write(pristine_b)
                with open(man_b, "wb") as f:
                    f.write(pristine_man_b)
            corrupt_checkpoint(path_b, kind)
            safety = 0
            while tr.supervisor.restore_events < i + 1 and safety < 12:
                step += 1
                safety += 1
                host_step(step)
            identical.append(_leaves_equal(tr.train_state(host=True),
                                           snap_a))
        # post-incident recovery: the two clean steps after the rewind
        for _ in range(2):
            step += 1
            host_step(step)

        journal = list(tr.run_journal.entries)
        n = len(kinds)
        idx_vf = _event_indices(journal, "ckpt_verify_failed",
                                path=path_b)
        idx_cr = _event_indices(journal, "ckpt_restore", path=path_a)
        idx_rs = _event_indices(journal, "restore", ckpt=path_a)
        reasons = [journal[i]["reason"] for i in idx_vf]
        _check(checks, "restores_fired",
               tr.supervisor.restore_events == n and len(idx_rs) == n,
               f"restore_events={tr.supervisor.restore_events}, "
               f"{len(idx_rs)} restore records for A")
        _check(checks, "verify_failed_precedes_restore",
               len(idx_vf) >= n and len(idx_cr) == n
               and all(idx_vf[i] < idx_cr[i] < idx_rs[i]
                       for i in range(min(n, len(idx_rs)))),
               f"verify_failed@{idx_vf} ckpt_restore@{idx_cr} "
               f"restore@{idx_rs}")
        expected = {"ckpt_truncate": "size_mismatch",
                    "ckpt_bitflip": "digest_mismatch",
                    "ckpt_torn": "size_mismatch"}
        _check(checks, "rejection_reasons",
               len(reasons) >= n
               and all(reasons[i].startswith(expected[k])
                       for i, k in enumerate(kinds)),
               f"reasons={reasons}")
        _check(checks, "fallback_depth_one",
               all(journal[i].get("fallback_depth") == 1
                   and journal[i].get("legacy") is False
                   for i in idx_cr),
               f"ckpt_restore events: {[journal[i] for i in idx_cr]}")
        _check(checks, "state_bit_identical",
               len(identical) == n and all(identical),
               f"rounds identical to A: {identical}")
        _check(checks, "recovered",
               all(np.isfinite(losses[-2:])),
               f"post-restore losses {losses[-2:]}")

        # drain barrier: an async save in flight at (simulated)
        # preemption time publishes whole — verified file, no tmp
        final = ac.save(tr.train_state(), step,
                        qualified=tr.checkpoint_qualified)
        drained = ac.drain(timeout=60.0)
        _check(checks, "drain_publishes_whole",
               drained and verify_checkpoint(final).ok
               and not os.path.exists(final + ".tmp"),
               f"drained={drained}")

        # the torn round's stale tmp remnant: fresh tmp files survive
        # the scan (an async writer may own them); aged ones are swept
        remnant = path_b + ".tmp"
        had_remnant = os.path.exists(remnant)
        if had_remnant:
            os.utime(remnant, (0, 0))
        latest_checkpoint(ckpt_dir)
        _check(checks, "stale_tmp_swept",
               had_remnant and not os.path.exists(remnant),
               f"remnant existed={had_remnant}, "
               f"still there={os.path.exists(remnant)}")

        # legacy checkpoint: a file whose manifest is gone (one written
        # before the manifests) is accepted with the flag set
        legacy_dir = os.path.join(ckpt_dir, "legacy")
        lpath = save_checkpoint(legacy_dir, tr.train_state(), 1)
        os.remove(lpath[: -len(".msgpack")] + ".manifest.json")
        _, lstep, _, _, legacy = verified_restore(
            legacy_dir, tr.train_state(gather=False),
            journal=tr.supervisor.journal, step=step)
        _check(checks, "legacy_restores", legacy and lstep == 1,
               f"legacy={legacy} step={lstep}")

        journal = list(tr.run_journal.entries)
        _validate(checks, journal)
        return DrillReport(
            "ckpt_corruption", checks, journal,
            notes={"kinds": list(kinds), "reasons": reasons,
                   "losses": losses,
                   "ckpts": {"a": path_a, "b": path_b}})
    finally:
        ac.close(timeout=60.0)
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


# ---- catalog ------------------------------------------------------------

DRILLS: Dict[str, Callable[..., DrillReport]] = {
    "chip_loss": drill_chip_loss,
    "latency_retune": drill_latency_retune,
    "density_backoff": drill_density_backoff,
    "ckpt_corruption": drill_ckpt_corruption,
}


def run_drill(name: str, **kwargs) -> DrillReport:
    """Run one catalog drill by name."""
    if name not in DRILLS:
        raise KeyError(f"unknown drill {name!r}; one of {sorted(DRILLS)}")
    return DRILLS[name](**kwargs)
