"""The distributed gradient step: flat gradient -> sparse allreduce.

Counterpart of the collective half of
``oktopk_tpu/optim/distributed.py``: ``flat_size``, ``bucket_partition``
and ``bucket_sizes`` (:58-99), per-bucket ``SparseState``, and the
per-bucket loop of ``build_sparse_grad_step`` (:154-243, :299-398): a
compressor plan (one name, or one per bucket) with optional per-bucket
densities, momentum correction (a per-bucket [W, n_b] local momentum
folded into the gradient before compression), ``profile_norm`` (the
``eps_vs_dense`` metric), the ``grad_norm`` and ``grad_nonfinite``
metrics of the reduced gradient, the quality taps (:349-360,
:464-478; the tap is ``obs/quality.py``), and the anomaly guard with the
fault plans (:333-366, :418-478; ``resilience/``). Microbatch
accumulation and gradient clipping act on the local gradient before it
gets here (``train/trainer.py``). A plan naming ``hierarchical`` is
refused: that step is two-level and this one flat.

With ``quality`` (an ``obs.quality.QualityConfig``) each bucket owns a
``QualityBuffer`` of the comm's W rows (``self.qualities``, allocated as
``init_dist_state(quality=...)`` does, :102-151). Each step measures the
bucket after the compressor, against the dense reference ``pmean(flat +
residual)`` taken after the momentum fold, and commits the row after the
step with the guard's agreed skip flag (False without a guard). The
taps only read the step: the reduced gradient and every state are the
same with them on or off. They stay on the device: the host drains the
rings on its own
cadence (``Trainer._flush_quality``), so between flushes they add no
host sync.

With ``guard`` (a ``resilience.guard.GuardConfig``) or ``fault_plan`` (a
``resilience.faults.FaultPlan``) the step owns a ``HealthState``
(``self.health``, the attempted-step clock), as ``init_dist_state``
allocates one (:143-146). Per bucket, in the JAX step's order: the
plan's gradient faults, the momentum fold, the algorithm, the quality
tap, then the guard's local anomaly count of the gradient and the
reduced result, and the result's peak magnitude. After the loop the
counts are psum'd (``guard.agree``); on a trip every ``SparseState`` is
the old one with the new counters (step, volumes, wire bytes, counts and
the host step), the momenta the old ones, and the health clock
advances either way (with a plan and no guard, unflagged). The device
skip flag is returned, so the caller rolls back what it owns (the
parameters, the optimizer, the BatchNorm statistics): nothing here
reads it on the host.

Each bucket's algorithm runs inside the bucket's container scope
(``obs/anatomy.py``; JAX's :347), so the algorithm's phase ranges carry
the bucket's index, and its work outside every phase lands on phase
``other`` of that bucket. While a span recorder is on, the whole call is
the recorder's ``grad_step`` span (``obs/anatomy.py``), the metrics'
gather and the guard included.

The flat gradient [W, n] is laid out in the JAX package's leaf order and
layout (the trainer builds it), so that buckets, region boundaries and
selections are the same as the reference's. Buckets are contiguous leaf
ranges, so each bucket is a column slice of the flat buffer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from oktopk_tpu_torch import resolve_device
from oktopk_tpu_torch.collectives.registry import (
    TWO_LEVEL_ONLY,
    get_algorithm,
)
from oktopk_tpu_torch.collectives.state import (SKIP_ADVANCES, SparseState,
                                              init_state)
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.obs.anatomy import GRAD_STEP, phase_scope, span
from oktopk_tpu_torch.obs.metrics_buffer import init_buffer
from oktopk_tpu_torch.obs.quality import commit, measure_bucket
from oktopk_tpu_torch.resilience import guard as _guard
from oktopk_tpu_torch.resilience.faults import inject_grad_faults


def _sizes(leaves) -> List[int]:
    return [int(x) if isinstance(x, int) else int(x.numel()) for x in leaves]


def flat_size(leaves) -> int:
    """Total element count of a sequence of tensors (or sizes)."""
    return sum(_sizes(leaves))


def bucket_partition(leaves, num_buckets: int):
    """Contiguous leaf-index buckets in REVERSE leaf order, greedily
    balanced by element count (bucket 0 holds the last layers). Returns a
    list of ascending leaf-index lists."""
    sizes = _sizes(leaves)
    total = sum(sizes)
    L = len(sizes)
    num_buckets = max(1, min(num_buckets, L))
    target = total / num_buckets
    buckets, cur, acc = [], [], 0
    for pos, i in enumerate(reversed(range(L))):
        cur.append(i)
        acc += sizes[i]
        leaves_left = L - pos - 1
        still_needed = num_buckets - len(buckets) - 1
        if len(buckets) < num_buckets - 1 and (
                acc >= target - 1e-9 or leaves_left == still_needed):
            buckets.append(sorted(cur))
            cur, acc = [], 0
    buckets.append(sorted(cur))
    assert len(buckets) == num_buckets and all(buckets), buckets
    return buckets


def bucket_sizes(leaves, buckets) -> List[int]:
    sizes = _sizes(leaves)
    return [int(sum(sizes[i] for i in b)) for b in buckets]


class SparseGradStep:
    """One sparse collective per bucket over a flat [W, n] gradient.

    ``__call__(flat)`` returns the reduced flat gradient [n] (every worker
    holds the same result; row 0 is returned), the step's metrics
    (worker 0's, on every rank) and the guard's skip flag (a 0-d bool
    tensor on the device; None without a guard), and advances
    ``self.states`` (one ``SparseState`` per bucket), under momentum
    correction ``self.momenta``, with the taps ``self.qualities`` and
    with a guard or a plan ``self.health``.

    ``compressor`` is one registry name for every bucket or one name per
    bucket; ``bucket_densities`` overrides the density per bucket
    (``replan`` changes both and keeps every state).
    ``momentum_correction`` is the momentum factor folded in before
    compression (0 = off). ``quality`` (an ``obs.quality.QualityConfig``)
    adds the quality taps and their rings. ``guard`` and ``fault_plan``
    add the anomaly guard and the planned gradient faults. ``device``
    is where the states live: CUDA unless the caller asks for the CPU."""

    def __init__(self, cfg: OkTopkConfig, comm, leaves: Sequence,
                 compressor: Union[str, Sequence[str]] = "oktopk",
                 num_buckets: int = 1, warmup: bool = True, device=None,
                 bucket_densities: Optional[Sequence[float]] = None,
                 momentum_correction: float = 0.0,
                 profile_norm: bool = False, quality=None, guard=None,
                 fault_plan=None):
        device = resolve_device(device)
        self.comm = comm
        self.warmup = warmup
        self.buckets = bucket_partition(leaves, num_buckets)
        nb = len(self.buckets)
        sizes = _sizes(leaves)
        offs = [0]
        for s in sizes:
            offs.append(offs[-1] + s)
        if offs[-1] != cfg.n:
            raise ValueError(f"cfg.n={cfg.n} != flat size {offs[-1]}")
        self.ranges = [(offs[b[0]], offs[b[-1] + 1]) for b in self.buckets]
        self.replan(compressor, bucket_densities, cfg)
        self.states: List[SparseState] = [
            init_state(c, comm.local_workers, device) for c in self.cfgs]
        self.momentum_correction = float(momentum_correction)
        self.momenta = ([torch.zeros((comm.local_workers, c.n),
                                     device=device) for c in self.cfgs]
                        if self.momentum_correction else None)
        self.profile_norm = profile_norm
        self.qualities = (
            [init_buffer(quality.every, quality.sig_bins,
                         comm.local_workers, device) for _ in self.cfgs]
            if quality is not None else None)
        # the skip flag of every commit, on the device once: a flag made
        # from a Python bool at each step would be a copy to the card
        self._no_skip = torch.zeros(comm.local_workers, dtype=torch.bool,
                                    device=device)
        self.guard = guard
        self.fault_plan = fault_plan
        self.health = (_guard.init_health(nb, device)
                       if guard is not None or fault_plan is not None
                       else None)

    def replan(self, compressor: Union[str, Sequence[str]],
               bucket_densities: Optional[Sequence[float]] = None,
               cfg: Optional[OkTopkConfig] = None) -> None:
        """Swap the per-bucket algorithms and their configs (a dense
        fallback, a density backoff level, another density schedule in
        ``cfg``), keeping the states, momenta, quality rings and health:
        the JAX Trainer's step rebuild, whose state lives outside the
        step and so is never reset by it."""
        cfg = self.cfg if cfg is None else cfg
        nb = len(self.buckets)
        names = ([compressor] * nb if isinstance(compressor, str)
                 else list(compressor))
        if len(names) != nb:
            raise ValueError(f"compressor plan has {len(names)} entries "
                             f"for {nb} buckets")
        if "hierarchical" in names:
            raise ValueError(TWO_LEVEL_ONLY)
        if bucket_densities is not None and len(bucket_densities) != nb:
            raise ValueError(f"bucket_densities has {len(bucket_densities)}"
                             f" entries for {nb} buckets")
        self.cfg = cfg
        self.names = names
        self.algos = [get_algorithm(nm, warmup=self.warmup) for nm in names]
        self.cfgs = []
        for i, (s, e) in enumerate(self.ranges):
            over = {} if nb == 1 else {"n": e - s, "bucket_index": i}
            if bucket_densities is not None:
                over["density"] = float(bucket_densities[i])
            self.cfgs.append(cfg.replace(**over) if over else cfg)

    def __call__(self, flat: torch.Tensor):
        with span(GRAD_STEP):
            return self._reduce(flat)

    def _reduce(self, flat: torch.Tensor):
        reduced = torch.empty(flat.shape[1], dtype=flat.dtype,
                              device=flat.device)
        vol = wbytes = lk = gk = 0.0
        eps_num = eps_den = 0.0
        taps, olds, old_moms, counts, absmaxes = [], [], [], [], []
        for bi, (s, e) in enumerate(self.ranges):
            g = flat if (s, e) == (0, flat.shape[1]) else flat[:, s:e]
            if self.fault_plan is not None:
                # planned faults, by the attempted-step clock: a skipped
                # step must not freeze a one-step fault into a lasting one
                g = inject_grad_faults(self.fault_plan, g,
                                       self.health.host_step,
                                       self.comm.first_worker, bi)
            if self.momenta is not None:
                old_moms.append(self.momenta[bi])
                g = self.momentum_correction * self.momenta[bi] + g
                self.momenta[bi] = g
            if self.qualities is not None:
                # the dense reference of the tap: what each worker handed
                # the compressor plus its residual, pmean'd
                dense_q = self.comm.pmean(g + self.states[bi].residual)
            olds.append(self.states[bi])
            with phase_scope(bucket=bi):
                out, st = self.algos[bi](g, self.states[bi], self.cfgs[bi],
                                         self.comm)
            reduced[s:e] = out[0]
            self.states[bi] = st
            if self.qualities is not None:
                q = self.qualities[bi]
                taps.append(measure_bucket(out, dense_q, st, q.prev_sig,
                                           q.prev_res_norm))
            if self.guard is not None:
                counts.append(_guard.local_anomaly_count(g, out, self.guard))
                # the guard-pressure signal of the density backoff: how
                # close the delivered gradient crowds abs_limit
                absmaxes.append(torch.max(torch.abs(out[0])))
            vol = vol + st.last_volume
            wbytes = wbytes + st.last_wire_bytes
            lk = lk + st.last_local_count.to(torch.float32)
            gk = gk + st.last_global_count.to(torch.float32)
            if self.profile_norm:
                dense = self.comm.pmean(g)[0]
                eps_num = eps_num + torch.sum((dense - out[0]) ** 2)
                eps_den = eps_den + torch.sum(dense ** 2)
        # the metrics of worker 0, on every rank (the JAX step returns them
        # replicated): one small all_gather across processes
        vol, wbytes, lk, gk = self.comm.all_gather(
            torch.stack([vol, wbytes, lk, gk], 1))[0, 0]
        metrics = {"grad_norm": torch.sqrt(torch.sum(reduced * reduced)),
                   "grad_nonfinite": torch.sum(~torch.isfinite(reduced)),
                   "comm_volume": vol, "wire_bytes": wbytes,
                   "local_k": lk, "global_k": gk}
        if self.profile_norm:
            metrics["eps_vs_dense"] = (torch.sqrt(eps_num)
                                       / (torch.sqrt(eps_den) + 1e-12))
        skip = None
        if self.guard is not None:
            flags, skip = _guard.agree(counts, self.comm)
            # a skipped step keeps every compressor state but its
            # counters (it consumed its batch and its wire)
            self.states = [
                _guard.guarded(skip, old.replace(**{
                    f: getattr(new, f) for f in SKIP_ADVANCES}), new)
                for old, new in zip(olds, self.states)]
            if self.momenta is not None:
                self.momenta = _guard.guarded(skip, old_moms, self.momenta)
            self.health = _guard.advance(self.health, skip, flags)
            metrics["step_skipped"] = skip.to(torch.int32)
            metrics["steps_skipped"] = self.health.steps_skipped
            metrics["bucket_anomalies"] = (flags > 0).to(torch.int32)
            # replicated; NaN when the step carried nonfinites (the skip
            # flag is authoritative there)
            metrics["reduced_absmax"] = torch.max(torch.stack(absmaxes))
        elif self.health is not None:
            # a plan without a guard: the attempt clock still advances,
            # or a one-step fault would re-inject forever
            h = self.health
            self.health = _guard.advance(
                h, torch.zeros((), dtype=torch.bool, device=h.step.device),
                torch.zeros_like(h.bucket_trips))
        if self.qualities is not None:
            # committed after the guard: the row always lands, flagged,
            # while the baselines freeze on a skipped step
            flag = (self._no_skip if skip is None
                    else skip.expand(self.comm.local_workers))
            self.qualities = [commit(q, st.step, scalars, flag)
                              for q, st, scalars in zip(
                                  self.qualities, self.states, taps)]
        return reduced, metrics, skip
