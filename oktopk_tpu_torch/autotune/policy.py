"""Plan selection: cost-model prior -> trial posterior, with hysteresis.

Counterpart of ``oktopk_tpu/autotune/policy.py`` (``Candidate`` :36,
``BucketPlan`` :67, ``predict_ms`` :85, ``AutotunePolicy`` :147,
``make_candidates`` :248, ``Autotuner`` :272), copied, plan mode
included, over the port's ``comm/fabric.py`` presets; ``Autotuner.
calibrate(comm=...)`` and ``tune(step, comm=...)`` take the comm where
JAX's take a mesh, and the tuner journals through the port's
``autotune/journal.py::DecisionJournal``.

The decision unit is the gradient bucket (``optim.distributed.
bucket_partition``): each bucket independently picks a collective
algorithm and density. Priors come from the alpha-beta cost model with
coefficients calibrated by ``autotune.calibrate``; posteriors are the
measured trial step times from ``autotune.trial``. The chosen plan only
changes when a challenger beats the incumbent's *fresh* measurement by
more than the hysteresis margin — mirroring the paper's periodic
threshold re-estimation cadence, and keeping borderline buckets from
flip-flopping the step into a re-plan every re-tune.

Across processes every rank decides on the same numbers: the
coefficients are fitted from medians agreed over the ranks, the trials'
medians are agreed too (``calibrate.agree_max``), and the candidate
order follows from both, so every rank runs the same trials in the same
order and adopts the same plan.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from oktopk_tpu_torch.autotune.calibrate import (FabricCoefficients,
                                                 _design_row,
                                                 default_coefficients)
from oktopk_tpu_torch.autotune.journal import DecisionJournal
from oktopk_tpu_torch.comm.fabric import (PLAN_SELECT_GAMMA, TwoLevelFabric,
                                          resolve_two_level)
from oktopk_tpu_torch.utils.cost_model import (allgather_cost,
                                               allreduce_cost,
                                               sparse_allreduce_cost,
                                               topk_cost)

# Algorithms whose wire pattern is "local top-k, then allgather the
# winners" — their comm volume scales as kP pairs (logs/algo_sweep.json
# measured 2kP transmitted scalars for topkA), unlike oktopk's balanced
# O(k) two-phase exchange.
_ALLGATHER_FAMILY = ("topkA", "topkA2", "topkAopt", "gtopk", "gaussiank",
                     "gaussiankconcat", "gaussiankSA", "topkSA", "topkDSA")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (algorithm, density) point in the search space. ``density`` is
    1.0 for dense (ignored by the algorithm, kept for the journal).

    ``algo="hierarchical"`` names the two-level composition
    (collectives/hierarchical.py): dense intra-pod plus ``outer`` (a flat
    registry algorithm) across pods at ``density``. Hierarchical
    candidates are priced by the per-level fabric model and require the
    tuner's ``fabric``/``num_pods`` plan-mode inputs."""

    algo: str
    density: float = 1.0
    outer: Optional[str] = None     # hierarchical only: inter-level algo

    def key(self) -> Tuple[str, float, Optional[str]]:
        return (self.algo, self.density, self.outer)

    def as_dict(self):
        d = {"algo": self.algo, "density": self.density}
        if self.algo == "hierarchical":
            out = self.outer or "oktopk"
            d["outer"] = out
            # the per-level (algorithm, density) plan the journal carries
            d["levels"] = [
                {"level": "intra", "algo": "dense", "density": 1.0},
                {"level": "inter", "algo": out, "density": self.density},
            ]
        return d


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The tuner's decision for one gradient bucket."""

    bucket: int                  # bucket index (reverse-layer order)
    n: int                       # flat element count of the bucket
    algo: str
    density: float
    predicted_ms: float          # cost-model prior of the chosen candidate
    measured_ms: float           # trial posterior of the chosen candidate
    outer: Optional[str] = None  # hierarchical plans: inter-level algo

    def key(self) -> Tuple[str, float, Optional[str]]:
        return (self.algo, self.density, self.outer)

    def as_dict(self):
        return dataclasses.asdict(self)


def predict_ms(algo: str, density: float, n: int, num_workers: int,
               coeffs: FabricCoefficients, *,
               fabric: Optional[TwoLevelFabric] = None,
               num_pods: Optional[int] = None,
               outer: Optional[str] = None,
               select_gamma: Optional[float] = None) -> float:
    """α-β cost-model prior for one candidate, in milliseconds.

    dense: ring allreduce of n elements. oktopk: local selection +
    the paper's two-phase O(k) exchange. The allgather family: local
    selection + ring allgather of every worker's 2k-scalar (index, value)
    winners. Selection cost uses the sort-free γ·n estimate shared by all
    sparse candidates — the model only needs to rank, the trial phase
    measures.

    ``algo="hierarchical"`` prices the two-level composition per level
    with a :class:`~oktopk_tpu_torch.comm.fabric.TwoLevelFabric`: a dense ring
    allreduce of the pod (``num_workers / num_pods`` members) on the
    intra fabric, plus the flat ``outer`` candidate at ``density`` among
    ``num_pods`` leaders on the inter fabric. When a ``fabric`` is given
    (preset planning, no measured chip), selection is priced with
    ``select_gamma`` — defaulting to ``PLAN_SELECT_GAMMA``, the HBM-class
    element-pass rate — uniformly across candidates so flat and
    hierarchical compete on the same scale.
    """
    a, b = coeffs.alpha, coeffs.beta
    p = max(1, num_workers)
    if select_gamma is None and fabric is not None:
        select_gamma = PLAN_SELECT_GAMMA
    if algo == "hierarchical":
        if fabric is None or num_pods is None:
            raise ValueError(
                "hierarchical candidate needs fabric=TwoLevelFabric and "
                "num_pods (per-level pricing has no single-coeffs form)")
        two = resolve_two_level(fabric)
        pods = max(1, int(num_pods))
        pod = max(1, p // pods)
        t_intra = (allreduce_cost(n, pod, two.intra.alpha_s,
                                  two.intra.beta_elem()) * 1e3
                   if pod > 1 else 0.0)
        return t_intra + predict_ms(outer or "oktopk", density, n, pods,
                                    two.inter.coefficients(),
                                    select_gamma=select_gamma)
    if algo == "dense":
        if p == 1:
            # same degenerate (1, n) law the P=1 calibration fits: alpha
            # is the dispatch floor, beta the per-element memory pass —
            # the ring formula would predict exactly 0 for every n
            ca, cb = _design_row(n, p)
            return (ca * a + cb * b) * 1e3
        return allreduce_cost(n, p, a, b) * 1e3
    k = max(1, int(density * n))
    sel = topk_cost(n) if select_gamma is None else topk_cost(n, select_gamma)
    if algo == "oktopk":
        return (sel + sparse_allreduce_cost(k, p, a, b)) * 1e3
    if algo in _ALLGATHER_FAMILY:
        return (sel + allgather_cost(2 * k, p, a, b)) * 1e3
    raise ValueError(f"no cost model for algorithm {algo!r}")


@dataclasses.dataclass(frozen=True)
class AutotunePolicy:
    """Decision knobs (see TrainConfig.autotune_* for the CLI surface)."""

    candidates: Tuple[Candidate, ...]
    hysteresis: float = 0.15       # challenger must win by this fraction
    retune_every: int = 0          # steps between re-tunes; 0 = tune once
    max_trials: int = 0            # 0 = trial every candidate; else only
    # the top-``max_trials`` by cost-model prior are measured (prior
    # pruning — the "cost-model prior -> trial posterior" funnel)

    def __post_init__(self):
        if not self.candidates:
            raise ValueError("autotune needs at least one candidate")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in [0, 1), got {self.hysteresis}")

    def decide(self, bucket: int, n: int, num_workers: int,
               coeffs: FabricCoefficients,
               measure: Optional[Callable[[str, int, float], float]],
               incumbent: Optional[BucketPlan] = None,
               journal: Optional[DecisionJournal] = None,
               step: int = 0,
               fabric: Optional[TwoLevelFabric] = None,
               num_pods: Optional[int] = None,
               select_gamma: Optional[float] = None) -> BucketPlan:
        """Pick the plan for one bucket; journals the full evidence.

        ``measure=None`` is PLAN mode: no trial runs, the cost-model
        prior stands in for the posterior (reason ``"plan"``) — used
        when planning for a target (P, fabric) the current chips cannot
        measure. Hierarchical candidates are always model-priced (a
        flat trial comm cannot run the two-level composition)."""
        if fabric is not None:
            fabric = resolve_two_level(fabric)

        def _predict(c: Candidate) -> float:
            return predict_ms(c.algo, c.density, n, num_workers, coeffs,
                              fabric=fabric, num_pods=num_pods,
                              outer=c.outer, select_gamma=select_gamma)

        scored = [(_predict(c), c) for c in self.candidates]
        scored.sort(key=lambda pc: pc[0])
        trialed = scored
        if self.max_trials > 0:
            trialed = scored[:self.max_trials]
            # the incumbent is always re-measured: hysteresis compares
            # against its FRESH time, not a stale one
            if incumbent is not None and not any(
                    c.key() == incumbent.key() for _, c in trialed):
                trialed = trialed + [
                    (p, c) for p, c in scored if c.key() == incumbent.key()]

        def _posterior(pred: float, c: Candidate) -> float:
            if measure is None or c.algo == "hierarchical":
                return pred
            return measure(c.algo, n, c.density)

        rows = [{**c.as_dict(), "predicted_ms": pred,
                 "measured_ms": _posterior(pred, c)}
                for pred, c in trialed]
        trialed_keys = {c.key() for _, c in trialed}
        skipped = [{**c.as_dict(), "predicted_ms": pred, "measured_ms": None}
                   for pred, c in scored[len(trialed):]
                   if c.key() not in trialed_keys]
        best = min(rows, key=lambda r: r["measured_ms"])
        reason = "plan" if measure is None else "trial"
        chosen = best
        if incumbent is not None:
            inc_fresh = next(
                (r for r in rows
                 if (r["algo"], r["density"], r.get("outer")) ==
                 incumbent.key()), None)
            if inc_fresh is not None and (
                    best["measured_ms"]
                    >= inc_fresh["measured_ms"] * (1.0 - self.hysteresis)):
                chosen, reason = inc_fresh, "hold"
        plan = BucketPlan(bucket=bucket, n=n, algo=chosen["algo"],
                          density=chosen["density"],
                          predicted_ms=chosen["predicted_ms"],
                          measured_ms=chosen["measured_ms"],
                          outer=chosen.get("outer"))
        if journal is not None:
            chosen_dict = {k: chosen[k]
                           for k in ("algo", "density", "outer", "levels")
                           if k in chosen}
            journal.record(
                "decision", step=step, bucket=bucket, n=n,
                num_workers=num_workers, candidates=rows + skipped,
                chosen=chosen_dict,
                incumbent=(None if incumbent is None else
                           {"algo": incumbent.algo,
                            "density": incumbent.density,
                            **({"outer": incumbent.outer}
                               if incumbent.outer else {})}),
                reason=reason,
                **({"fabric": fabric.name, "num_pods": int(num_pods or 1)}
                   if fabric is not None else {}))
        return plan


def make_candidates(algos: Sequence[str],
                    densities: Sequence[float],
                    hierarchical_outers: Sequence[str] = ()
                    ) -> Tuple[Candidate, ...]:
    """Cross sparse algorithms with the density grid; dense gets the single
    density-1.0 point. ``hierarchical_outers`` adds two-level candidates —
    one per (outer algorithm, density) pair — for plan-mode tuners that
    carry a ``fabric``/``num_pods`` target."""
    out: List[Candidate] = []
    for a in algos:
        if a == "dense":
            out.append(Candidate("dense", 1.0))
        else:
            for d in densities:
                out.append(Candidate(a, float(d)))
    for o in hierarchical_outers:
        if o == "dense":
            out.append(Candidate("hierarchical", 1.0, outer="dense"))
        else:
            for d in densities:
                out.append(Candidate("hierarchical", float(d), outer=o))
    return tuple(out)


class Autotuner:
    """Orchestrates calibrate -> trial -> policy over a bucket list.

    ``bucket_sizes`` are the flat element counts from
    ``optim.distributed.bucket_sizes`` (reverse-layer order, like the
    per-bucket SparseState). The tuner owns the decision journal and the
    current plan list; the trainer consults ``plans`` when (re)building
    its step and calls ``should_retune``/``tune`` on the configured
    cadence.

    ``fabric`` switches the tuner to PLAN mode: a named fabric preset
    (``"dcn"``), a :class:`~oktopk_tpu_torch.comm.fabric.FabricPreset`, or a
    :class:`~oktopk_tpu_torch.comm.fabric.TwoLevelFabric` describing the
    TARGET deployment rather than the chips underfoot. Calibration then
    takes α-β from the preset's inter edge (no probing), trials are
    skipped (``measure=None`` — the prior stands), and hierarchical
    candidates become priceable (``num_pods`` splits ``num_workers``
    into pods). ``runner`` may be ``None`` in plan mode.
    """

    def __init__(self, bucket_sizes: Sequence[int], num_workers: int,
                 policy: AutotunePolicy, runner,
                 coeffs: Optional[FabricCoefficients] = None,
                 journal: Optional[DecisionJournal] = None,
                 calibration_sizes: Optional[Sequence[int]] = None,
                 fabric=None, num_pods: Optional[int] = None):
        self.bucket_sizes = [int(s) for s in bucket_sizes]
        self.num_workers = int(num_workers)
        self.policy = policy
        self.runner = runner
        self.journal = journal if journal is not None else DecisionJournal()
        self.coeffs = coeffs
        self.calibration_sizes = calibration_sizes
        self.fabric: Optional[TwoLevelFabric] = (
            None if fabric is None else resolve_two_level(fabric))
        self.num_pods = None if num_pods is None else int(num_pods)
        if self.fabric is None and runner is None:
            raise ValueError("Autotuner needs a trial runner unless a "
                             "fabric preset puts it in plan mode")
        self.plans: Optional[List[BucketPlan]] = None
        self.last_tune_step: Optional[int] = None

    def calibrate(self, comm=None, step: int = 0) -> FabricCoefficients:
        """Fit α-β from probe collectives over ``comm``, on the trial
        runner's device (falls back to the cost-model defaults when no
        comm is available to probe). In plan mode the preset's inter-edge
        coefficients are used verbatim — the point is to price a fabric
        the current chips cannot exhibit."""
        from oktopk_tpu_torch.autotune.calibrate import (DEFAULT_PROBE_SIZES,
                                                         probe_fabric)

        if self.fabric is not None:
            self.coeffs = self.fabric.inter.coefficients()
        elif comm is not None:
            sizes = tuple(self.calibration_sizes or DEFAULT_PROBE_SIZES)
            device = self.runner.device if self.runner is not None else None
            self.coeffs = probe_fabric(comm, sizes=sizes, device=device)
        elif self.coeffs is None:
            self.coeffs = default_coefficients()
        self.journal.record("calibration", step=step,
                            num_workers=self.num_workers,
                            **self.coeffs.as_dict())
        return self.coeffs

    def should_retune(self, step: int) -> bool:
        if self.plans is None:
            return True
        if self.policy.retune_every <= 0:
            return False
        return step - (self.last_tune_step or 0) >= self.policy.retune_every

    def tune(self, step: int = 0, comm=None) -> List[BucketPlan]:
        """One full trial pass over every bucket. Returns the new plan
        list; ``plans_changed`` against the previous one tells the caller
        whether the train step must be re-planned."""
        if self.coeffs is None:
            self.calibrate(comm=comm, step=step)
        old = self.plans
        plan_mode = self.fabric is not None
        measure = None if plan_mode else self.runner.measure
        self.plans = [
            self.policy.decide(
                bi, n, self.num_workers, self.coeffs, measure,
                incumbent=(old[bi] if old is not None else None),
                journal=self.journal, step=step,
                fabric=self.fabric, num_pods=self.num_pods,
                select_gamma=PLAN_SELECT_GAMMA if plan_mode else None)
            for bi, n in enumerate(self.bucket_sizes)]
        self.last_tune_step = step
        return self.plans

    @staticmethod
    def plans_changed(new: Optional[Sequence[BucketPlan]],
                      old: Optional[Sequence[BucketPlan]]) -> bool:
        if old is None or new is None:
            return old is not new
        return [p.key() for p in new] != [p.key() for p in old]
