"""Ok-Topk: the two-phase O(6k) sparse allreduce.

Counterpart of ``oktopk_tpu/collectives/oktopk.py:65-447`` (``_target_k``,
``_newton_adapt``, ``_repartition``, ``oktopk``). Phase (a) packs each
worker's selection into per-region fixed-capacity buffers, exchanges them
with one all_to_all to the region owners, and adds them up; phase (b)
selects each owner's global winners and allgathers them. Thresholds are
predicted by a Newton/drift controller and recomputed exactly on a
cadence; regions are repartitioned by local selection density.

Every per-worker tensor carries the comm's leading worker dimension
``[W, ...]`` (``comm/stacked.py``); the kernels run once per worker row.
Each ``lax.cond`` of the JAX form depends only on the step counter, so it
is a Python ``if`` on ``state.host_step`` here.

Two rungs, as in the JAX package: the fused front-end (the fused select
kernel, then the compaction kernel fed its tile counts) by default, and
the unfused passes with ``cfg.fuse_select=False`` (separate residual add,
mask, count, probe, and the compaction kernel's own count pass). Both
follow the JAX ``use_pallas=True`` contract: selection thresholds clamped
to the smallest normal f32, the Newton probe not clamped.

Phase scopes (``obs/anatomy.py``) sit where the JAX form opens them
(:157-432), on its fused branch: the residual add, the thresholds, the
fused sweep and the phase-(b) selections under ``select``; the
repartition and the region pack under ``stage``; the wire casts and the
comm's ``all_to_all``/``all_gather`` under ``exchange``; the scatters and
the residual under ``combine``. The volume counts and the two psums of
phase (b) stay outside every phase, as in JAX. While a span recorder is
on, the step's host-side decisions (``exact``, ``local_recompute``,
``repartition``, ``first_sparse``, ``host_step``) are attributes of the
enclosing bucket span (``anatomy.annotate``).

Phase-(a) combine order: up to P contributions land on one index; they
are added one source row at a time in rank order, as the JAX scatter does
on the CPU, so float sums agree bit-for-bit (no atomics collide: the
indices within one row are distinct). The sentinel index n drops. The
scatters and the residual update are ``ops/combine.py``: on the card its
kernels, one pass each over contiguous [W, n] rows, the masks and the
bf16 roundings in registers.
"""

from __future__ import annotations

import torch

from oktopk_tpu_torch.collectives.state import SparseState, bump
from oktopk_tpu_torch.collectives.wire import on_wire, pair_wire_bytes
from oktopk_tpu_torch.config import OkTopkConfig, scheduled_k, target_k
from oktopk_tpu_torch.obs.anatomy import annotate, phase_scope
from oktopk_tpu_torch.ops import combine, compaction
from oktopk_tpu_torch.ops.fused_select import (
    fused_pack_finalize,
    fused_select_stage,
)
from oktopk_tpu_torch.ops.hist_threshold import (
    hist_to_threshold,
    k2threshold_hist,
    log2_hist,
)
from oktopk_tpu_torch.ops.topk import cumsum_rows, k2threshold_method

_F32 = torch.float32


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a 0-d float32 tensor on ``like``'s device (how
    the JAX form's weakly typed constants enter float32 arithmetic),
    filled there rather than copied from the host."""
    return torch.full((), v, dtype=_F32, device=like.device)


def _newton_adapt(thresh, count, count_probe, k: int, cfg: OkTopkConfig,
                  band_hi=None, target=None):
    """One damped Newton step of the threshold on the log-count/log-
    threshold slope measured by the probe count; left alone when the
    count is inside the band [band_lo*k, band_hi*k]. Elementwise over the
    worker dimension."""
    c = torch.clamp(count, min=1).to(_F32)
    cp = torch.clamp(count_probe, min=1).to(_F32)
    slope = (torch.log(cp) - torch.log(c)) / torch.log(
        _f32(cfg.probe_ratio, c))
    exponent = torch.clamp(-1.0 / torch.clamp(slope, max=-0.5),
                           cfg.newton_exp_lo, cfg.newton_exp_hi)
    corr = torch.pow(c / (k if target is None else target), exponent)
    corr = torch.clamp(corr, 1.0 / cfg.adapt_max_step, cfg.adapt_max_step)
    hi = cfg.band_hi if band_hi is None else band_hi
    cf = count.to(_F32)
    in_band = (cf >= _f32(cfg.band_lo * k, c)) & (cf <= _f32(hi * k, c))
    return torch.where(in_band, thresh, thresh * corr.to(thresh.dtype))


def _drift_update(lt_new, state: SparseState, cfg: OkTopkConfig):
    """Per-step threshold growth measured between consecutive exact
    recomputes, mixed into the carried drift estimate."""
    gap = max(1, cfg.local_recompute_every)
    base_lt = state.last_exact_lt
    one = torch.ones_like(lt_new)
    ratio = torch.where((lt_new > 0) & (base_lt > 0),
                        lt_new / torch.clamp(base_lt, min=1e-30), one)
    per_step = torch.clamp(torch.pow(ratio, _f32(1.0 / gap, ratio)),
                           cfg.drift_clip_lo, cfg.drift_clip_hi)
    mixed = ((1.0 - cfg.drift_ema) * state.drift
             + cfg.drift_ema * per_step)
    return torch.where(base_lt > 0, mixed, state.drift).to(lt_new.dtype)


def _repartition(abs_acc, local_thresh, cfg: OkTopkConfig, comm):
    """Load-balanced region boundaries [W, P+1]: quantile cut points of the
    cumulative local hit count, averaged over the workers (a psum in rank
    order of P float32 positions), rounded, sorted. The row-wise count is
    one scan of the flattened mask (``cumsum_rows``): bit-equal to a
    row-wise cumsum, and far faster on the card for a few long rows."""
    P, n = cfg.num_workers, cfg.n
    mask = abs_acc >= local_thresh[:, None]
    csum = cumsum_rows(mask, torch.int32)
    total = csum[:, -1]
    steps = torch.arange(1, P, dtype=torch.int32, device=abs_acc.device)
    targets = (steps[None, :] * total[:, None]).to(_F32) / P
    interior = torch.searchsorted(csum.to(_F32), targets,
                                  side="left").to(_F32)
    avg = comm.psum(interior) / P
    interior_i = torch.clamp(torch.round(avg).to(torch.int32), 0, n)
    interior_i = torch.sort(interior_i, dim=1).values
    W = abs_acc.shape[0]
    zeros = torch.zeros((W, 1), dtype=torch.int32, device=abs_acc.device)
    return torch.cat([zeros, interior_i, zeros + n], dim=1)


def _stack(rows):
    return [torch.stack(col) for col in zip(*rows)]


def oktopk(grad: torch.Tensor, state: SparseState, cfg: OkTopkConfig, comm):
    """One Ok-Topk allreduce of ``grad`` [W, n]; returns the reduced
    gradient [W, n] (the same on every worker) and the next state."""
    P, n = cfg.num_workers, cfg.n
    W = grad.shape[0]
    if grad.shape[1] != n:
        raise ValueError(f"grad has {grad.shape[1]} elements, cfg.n={n}")
    step = state.host_step
    k = scheduled_k(cfg, step)
    dev = grad.device
    rank = comm.rank(dev)
    hist_mode = cfg.threshold_method == "hist"
    fuse = cfg.fuse_select is not False and grad.dtype == _F32
    bkt = cfg.bucket_index

    if not fuse:
        with phase_scope("select", bkt):
            acc = grad + state.residual
            abs_acc = acc.abs()

    def abs_acc_rows():
        return (grad + state.residual).abs() if fuse else abs_acc

    first_sparse = step == cfg.warmup_steps
    recompute_local = step % cfg.local_recompute_every == 0 or first_sparse
    recompute_global = step % cfg.global_recompute_every == 0 or first_sparse
    prev_lt = state.local_threshold
    tkl = target_k(cfg, k, cfg.local_k_target)

    # ---- local threshold: exact on the cadence, else drift-predicted
    with phase_scope("select", bkt):
        if hist_mode:
            if first_sparse:
                a = abs_acc_rows()
                lt = torch.stack([k2threshold_hist(a[w], tkl)
                                  for w in range(W)]).to(grad.dtype)
            else:
                lt = prev_lt * state.drift
            drift = state.drift
        elif recompute_local:
            a = abs_acc_rows()
            lt = torch.stack([
                k2threshold_method(a[w], tkl, cfg.threshold_method,
                                   cfg.bisect_iters) for w in range(W)
            ]).to(grad.dtype)
            drift = _drift_update(lt, state, cfg)
            last_exact_lt = lt
        else:
            lt = prev_lt * state.drift
            drift, last_exact_lt = state.drift, state.last_exact_lt

    # ---- phase (a): select, pack per region, exchange, combine
    repart = step % cfg.repartition_every == 0 or first_sparse
    # the step's decisions, on the bucket's span while spans record
    annotate(host_step=step, exact=recompute_global,
             local_recompute=recompute_local, repartition=repart,
             first_sparse=first_sparse)
    if fuse:
        with phase_scope("select", bkt):
            probe_t = lt * _f32(cfg.probe_ratio, lt)
            stages = [fused_select_stage(grad[w], state.residual[w], lt[w],
                                         probe_t[w]) for w in range(W)]
            acc = torch.stack([s.acc for s in stages])
            local_count = torch.stack([s.local_count for s in stages])
            local_probe = torch.stack([s.probe_count for s in stages])
            hist = torch.stack([s.hist for s in stages])
        with phase_scope("stage", bkt):
            boundaries = (_repartition(acc.abs(), lt, cfg, comm) if repart
                          else state.boundaries)
            s_vals, s_idx, s_counts = _stack([
                fused_pack_finalize(stages[w], boundaries[w], P,
                                    cfg.cap_pair) for w in range(W)])
    else:
        with phase_scope("stage", bkt):
            boundaries = (_repartition(abs_acc, lt, cfg, comm) if repart
                          else state.boundaries)
        with phase_scope("select", bkt):
            mask = abs_acc >= lt[:, None]
            local_count = mask.sum(1, dtype=torch.int32)
        with phase_scope("stage", bkt):
            s_vals, s_idx, s_counts = compaction.pack_rows(
                acc, lt, boundaries, P, cfg.cap_pair)
        with phase_scope("select", bkt):
            probe_t = lt * _f32(cfg.probe_ratio, lt)
            local_probe = (abs_acc >= probe_t[:, None]).sum(
                1, dtype=torch.int32)
        hist = None

    with phase_scope("exchange", bkt):
        r_vals = comm.all_to_all(on_wire(s_vals, cfg, step)).to(acc.dtype)
        r_idx = comm.all_to_all(s_idx)
    with phase_scope("combine", bkt):
        reduced = combine.scatter_rows(n, r_vals, r_idx)  # own region

    sent_count = s_counts.sum(1, dtype=torch.int32)
    recv_count = (r_idx < n).sum((1, 2), dtype=torch.int32)
    own_count = s_counts.gather(1, rank.long()[:, None])[:, 0]
    vol_a = 2.0 * (sent_count - own_count) + 2.0 * (recv_count - own_count)

    # ---- local threshold feedback for the next step
    with phase_scope("select", bkt):
        if hist_mode and recompute_local:
            h = hist if hist is not None else torch.stack(
                [log2_hist(acc[w]) for w in range(W)])
            lt_next = torch.stack([hist_to_threshold(h[w], tkl)
                                   for w in range(W)]).to(grad.dtype)
            drift = _drift_update(lt_next, state, cfg)
            last_exact_lt = lt_next
        else:
            lt_next = _newton_adapt(lt, local_count, local_probe, k, cfg,
                                    target=tkl)
            if hist_mode:
                last_exact_lt = state.last_exact_lt

    # ---- phase (b): global winner selection + allgather
    if recompute_global:
        k_cand = min(cfg.cap_exact, n)
        with phase_scope("select", bkt):
            absr = reduced.abs()
            t_cand = torch.stack([
                k2threshold_method(absr[w], k_cand, cfg.threshold_method,
                                   cfg.bisect_iters) for w in range(W)])
            vals, idx, cand_count = compaction.select_rows(reduced, t_cand,
                                                           k_cand)
        with phase_scope("exchange", bkt):
            gv = comm.all_gather(on_wire(vals, cfg, step)).to(acc.dtype)
            gi = comm.all_gather(idx)
        k_pool = min(k, P * k_cand)
        with phase_scope("select", bkt):
            agv = gv.abs()
            gt = torch.stack([
                k2threshold_method(agv[w].reshape(-1), k_pool,
                                   cfg.threshold_method, cfg.bisect_iters)
                for w in range(W)]).to(acc.dtype)
            keep = (agv >= gt[:, None, None]) & (gi < n)
        with phase_scope("combine", bkt):
            zero = torch.zeros((), dtype=acc.dtype, device=dev)
            # gathered indices are globally distinct: dividing by P at
            # cap scale equals dividing the dense sum
            result = combine.scatter_rows(
                n, torch.where(keep, gv, zero) / P,
                torch.where(keep, gi, torch.full_like(gi, n)))
        g_count = keep.sum((1, 2), dtype=torch.int32)
        total_c = comm.psum(cand_count)
        vol_b = 2.0 * cand_count + 2.0 * (total_c - cand_count)
        gt_next = gt
    else:
        gt_use = state.global_threshold * drift
        with phase_scope("select", bkt):
            gvals, gidx, gcount = compaction.select_rows(reduced, gt_use,
                                                         cfg.cap_gather)
        with phase_scope("exchange", bkt):
            gv = comm.all_gather(on_wire(gvals, cfg, step)).to(acc.dtype)
            gi = comm.all_gather(gidx)
        with phase_scope("combine", bkt):
            result = combine.scatter_rows(n, gv / P, gi)
        probe_c = ((reduced.abs() >= (gt_use * _f32(cfg.probe_ratio,
                                                     gt_use))[:, None])
                   & (reduced != 0.0)).sum(1, dtype=torch.int32)
        totals = comm.psum(torch.stack([gcount, probe_c], 1).to(_F32))
        total_g = totals[:, 0].to(torch.int32)
        gt_next = _newton_adapt(
            gt_use, total_g, totals[:, 1].to(torch.int32), k, cfg,
            band_hi=cfg.band_hi_global,
            target=target_k(cfg, k, cfg.global_k_target))
        vol_b = 2.0 * gcount + 2.0 * (total_g - gcount)
        g_count = total_g

    # ---- residual: zero only at the global winners
    with phase_scope("combine", bkt):
        residual = combine.residual_after_winners(acc, lt, reduced, result,
                                                  cfg)
    vol = vol_a + vol_b
    wb = pair_wire_bytes(0.5 * vol, cfg)
    return result, bump(state, volume=vol, wire_bytes=wb,
                        residual=residual, local_threshold=lt_next,
                        global_threshold=gt_next, boundaries=boundaries,
                        drift=drift, last_exact_lt=last_exact_lt,
                        local_count=local_count, global_count=g_count)

