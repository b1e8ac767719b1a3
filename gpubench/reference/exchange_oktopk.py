"""Ok-Topk's sparse allreduce over P workers, plain PyTorch.

Shi, Li et al., "Near-optimal sparse allreduce for distributed deep
learning" (PPoPP'22, arXiv:2201.07598), as the JAX package's
``collectives/oktopk.py`` specifies it (a frozen copy of its semantics,
threshold method "bisect", the bf16 or float32 wire, no density
schedule). All P workers are rows of one [P, n] tensor; the exchanges
are their plain tensor forms (an all_to_all a transpose of [P, P, cap],
an all_gather every worker's copy of every row, a psum a sum over
workers).

One step of worker w, on acc = grad + residual:
(a) the local threshold, exact (a count bisection for the 0.9 k-th
    largest |acc|) every ``local_recompute_every`` steps, else the last
    one times the drift; the elements at or above it, in ascending
    index order, packed per region (boundaries re-cut from the workers'
    averaged count quantiles every ``repartition_every`` steps) up to
    ``cap_pair`` each, cast to the wire's type and sent to the region's
    owner, who adds what arrives in rank order;
(b) the global threshold, exact every ``global_recompute_every`` steps
    (up to ``cap_exact`` candidates a worker, gathered, and the k-th
    largest of the pool), else predicted; each owner's reduced values at
    or above it, up to ``cap_gather``, gathered by every worker, divided
    by P;
the residual keeps acc but at the global winners (under a bf16 wire,
the wire's rounding there); thresholds follow a damped Newton step on
the realised counts. The volume is 2 x (pairs sent + received, own
region excluded) in phase (a) plus 2 x (own candidates + the others')
in phase (b); ``wire_bytes`` is half the volume in (index, value) pairs
of 4 + 2 (bf16) or 4 + 4 bytes.

The harness finds this file by the cell's ``compressor``
(``reference/exchange_<compressor>.py``; see ``exchange_dense.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

MIN_NORMAL = 1.17549435e-38
_WAYS = 8
_LOG_RANGE_BITS = 64.0


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    n: int
    workers: int
    density: float
    local_recompute_every: int = 32
    global_recompute_every: int = 32
    repartition_every: int = 64
    warmup_steps: int = 0
    wire_dtype: str = "bfloat16"
    probe_ratio: float = 1.25
    newton_exp_lo: float = 0.03
    newton_exp_hi: float = 0.5
    adapt_max_step: float = 1.5
    drift_clip_lo: float = 0.5
    drift_clip_hi: float = 2.0
    drift_ema: float = 1.0
    band_lo: float = 2.0 / 3.0
    band_hi: float = 5.0 / 4.0
    band_hi_global: float = 1.0
    local_k_target: float = 0.9
    global_k_target: float = 0.85
    cap_pair_factor: float = 2.0
    cap_gather_factor: float = 2.5
    cap_exact_factor: float = 4.0
    bisect_iters: int = 30

    @property
    def k(self) -> int:
        return max(1, int(self.density * self.n))

    def cap(self, factor: float) -> int:
        return min(self.n, int(factor * self.k / max(1, self.workers)) + 8)

    @property
    def cap_pair(self) -> int:
        return self.cap(self.cap_pair_factor)

    @property
    def cap_gather(self) -> int:
        return self.cap(self.cap_gather_factor)

    @property
    def cap_exact(self) -> int:
        return self.cap(self.cap_exact_factor)

    @property
    def wire_pair_bytes(self) -> int:
        return 4 + (2 if self.wire_dtype == "bfloat16" else 4)

    def target_k(self, factor: float) -> int:
        if self.k >= self.n:
            return self.k
        return max(1, int(round(factor * self.k)))


def context(n: int, workers: int, density: float,
            config: Dict) -> SparseConfig:
    """The exchange's settings at this size: the configuration's
    ``sparse`` recipe (the harness's per-layer readers get it too)."""
    return SparseConfig(n=n, workers=workers, density=density,
                        **config["sparse"])


def program_settings(config: Dict) -> Dict:
    """The program's exchange settings (``trainer.algo_cfg``) that the
    configuration states: its ``sparse`` recipe."""
    return dict(config["sparse"])


def steady(cfg: SparseConfig, step: int) -> bool:
    """Whether step ``step`` (from 0) does the steady work: past the dense
    warmup, no exact threshold, no repartition."""
    return not (step <= cfg.warmup_steps
                or step % cfg.local_recompute_every == 0
                or step % cfg.global_recompute_every == 0
                or step % cfg.repartition_every == 0)


def init_state(cfg: SparseConfig, device) -> Dict:
    P, n = cfg.workers, cfg.n
    base, rem = divmod(n, P)
    cuts = [0]
    for i in range(P):
        cuts.append(cuts[-1] + base + (1 if i < rem else 0))
    f = torch.float32
    return {"step": 0,
            "lt": torch.zeros(P, dtype=f, device=device),
            "gt": torch.zeros(P, dtype=f, device=device),
            "drift": torch.ones(P, dtype=f, device=device),
            "last_exact_lt": torch.zeros(P, dtype=f, device=device),
            "bounds": torch.tensor(cuts, device=device).repeat(P, 1),
            "residual": torch.zeros((P, n), dtype=f, device=device)}


def _wire(x: torch.Tensor, cfg: SparseConfig) -> torch.Tensor:
    if cfg.wire_dtype == "float32":
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def _f(v, like):
    return torch.full((), v, dtype=torch.float32, device=like.device)


def kth_threshold(x_abs: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """The count bisection in log2 space: 8 geometric cuts a pass, 3 bits
    a pass over 64 binary orders below max|x|; the lower edge of the
    bracket where count(|x| > cut) crosses k, floored at 2^-126, 0 for an
    all-zero input."""
    hi0 = x_abs.max()
    e_hi = torch.log2(torch.clamp(hi0, min=1e-38)) + _f(1e-3, x_abs)
    lo, hi = e_hi - _f(_LOG_RANGE_BITS, x_abs), e_hi
    frac = torch.arange(1, _WAYS, dtype=torch.float32,
                        device=x_abs.device) / _WAYS
    for _ in range(-(-iters // 3)):
        cuts_e = lo + (hi - lo) * frac
        cuts = torch.exp2(cuts_e)
        counts = [x_abs.numel()] + [int((x_abs > c).sum()) for c in cuts]
        j = max(i for i, c in enumerate(counts) if c >= k)
        edges = torch.cat([lo.reshape(1), cuts_e, hi.reshape(1)])
        lo, hi = edges[j], edges[j + 1]
    t = torch.exp2(torch.clamp(lo, min=-126.0))
    return t if float(hi0) > 0 else torch.zeros_like(t)


def _selected(x: torch.Tensor, t: torch.Tensor, lo: int, hi: int, cap: int):
    """Indices in [lo, hi) with |x| >= max(t, smallest normal), ascending,
    the first ``cap`` of them."""
    t = torch.clamp(t, min=MIN_NORMAL)
    return (torch.nonzero(x[lo:hi].abs() >= t)[:, 0] + lo)[:cap]


def _newton(thresh, count, probe, k, target, band_hi, cfg: SparseConfig):
    c = torch.clamp(count, min=1).float()
    cp = torch.clamp(probe, min=1).float()
    slope = (torch.log(cp) - torch.log(c)) / torch.log(_f(cfg.probe_ratio, c))
    exponent = torch.clamp(-1.0 / torch.clamp(slope, max=-0.5),
                           cfg.newton_exp_lo, cfg.newton_exp_hi)
    corr = torch.clamp(torch.pow(c / target, exponent),
                       1.0 / cfg.adapt_max_step, cfg.adapt_max_step)
    cf = count.float()
    in_band = (cf >= cfg.band_lo * k) & (cf <= band_hi * k)
    return torch.where(in_band, thresh, thresh * corr)


def _repartition(abs_acc, lt, cfg: SparseConfig):
    P, n = cfg.workers, cfg.n
    cuts = []
    for w in range(P):
        csum = torch.cumsum((abs_acc[w] >= lt[w]).to(torch.int64), 0)
        total = int(csum[-1])
        targets = torch.tensor([s * total / P for s in range(1, P)],
                               dtype=torch.float32, device=abs_acc.device)
        cuts.append(torch.searchsorted(csum.float(), targets).float())
    avg = cuts[0]
    for c in cuts[1:]:                   # the psum adds in rank order
        avg = avg + c
    avg = avg / P
    interior = torch.sort(torch.clamp(torch.round(avg), 0, n).long()).values
    row = torch.cat([interior.new_zeros(1), interior,
                     interior.new_full((1,), n)])
    return row.repeat(P, 1)


def allreduce(grad: torch.Tensor, st: Dict, cfg: SparseConfig):
    """One step over ``grad`` [P, n]: (the reduced gradient [n], the next
    state, worker 0's wire bytes)."""
    P, n, step, k = cfg.workers, cfg.n, st["step"], cfg.k
    dev = grad.device
    acc = grad + st["residual"]
    absa = acc.abs()
    first = step == cfg.warmup_steps
    exact_local = step % cfg.local_recompute_every == 0 or first
    exact_global = step % cfg.global_recompute_every == 0 or first
    tkl = cfg.target_k(cfg.local_k_target)
    drift, last_exact = st["drift"], st["last_exact_lt"]
    if exact_local:
        lt = torch.stack([kth_threshold(absa[w], tkl, cfg.bisect_iters)
                          for w in range(P)])
        ratio = torch.where((lt > 0) & (last_exact > 0),
                            lt / torch.clamp(last_exact, min=1e-30),
                            torch.ones_like(lt))
        per_step = torch.clamp(
            torch.pow(ratio, 1.0 / max(1, cfg.local_recompute_every)),
            cfg.drift_clip_lo, cfg.drift_clip_hi)
        mixed = (1.0 - cfg.drift_ema) * drift + cfg.drift_ema * per_step
        drift = torch.where(last_exact > 0, mixed, drift)
        last_exact = lt
    else:
        lt = st["lt"] * drift
    bounds = st["bounds"]
    if step % cfg.repartition_every == 0 or first:
        bounds = _repartition(absa, lt, cfg)
    clamped = torch.clamp(lt, min=MIN_NORMAL)
    local_count = (absa >= clamped[:, None]).sum(1)
    probe_count = (absa >= (lt * cfg.probe_ratio)[:, None]).sum(1)

    # phase (a): worker w packs region r for its owner r
    reduced = torch.zeros((P, n), dtype=torch.float32, device=dev)
    sent = torch.zeros((P, P), dtype=torch.int64)
    packs = [[_selected(acc[w], lt[w], int(bounds[w, r]),
                        int(bounds[w, r + 1]), cfg.cap_pair)
              for r in range(P)] for w in range(P)]
    for r in range(P):                   # the owner adds in rank order
        for w in range(P):
            idx = packs[w][r]
            sent[w, r] = idx.numel()
            reduced[r].index_add_(0, idx, _wire(acc[w, idx], cfg))
    own = sent.diagonal()
    vol_a = 2 * (sent.sum(1) - own) + 2 * (sent.sum(0) - own)
    sent_mask = absa >= lt[:, None]
    lt_next = _newton(lt, local_count, probe_count, k, tkl, cfg.band_hi, cfg)

    # phase (b): the global winners, gathered
    result = torch.zeros(n, dtype=torch.float32, device=dev)
    if exact_global:
        k_cand = min(cfg.cap_exact, n)
        absr = reduced.abs()
        cand = [_selected(reduced[r], kth_threshold(absr[r], k_cand,
                                                    cfg.bisect_iters),
                          0, n, k_cand) for r in range(P)]
        pool = [_wire(reduced[r, c], cfg) for r, c in enumerate(cand)]
        counts = torch.tensor([c.numel() for c in cand])
        pooled = torch.cat(pool) if pool else torch.zeros(0, device=dev)
        gt = kth_threshold(torch.cat([pooled.abs(), torch.zeros(
            P * k_cand - pooled.numel(), device=dev)]),
            min(k, P * k_cand), cfg.bisect_iters)
        for r in range(P):
            keep = pool[r].abs() >= gt
            result.index_add_(0, cand[r][keep], pool[r][keep] / P)
        vol_b = 2 * counts + 2 * (counts.sum() - counts)
        gt_next = gt.expand(P).clone()
    else:
        gt_use = st["gt"] * drift
        winners = [_selected(reduced[r], gt_use[r], 0, n, cfg.cap_gather)
                   for r in range(P)]
        for r in range(P):
            idx = winners[r]
            result.index_add_(0, idx, _wire(reduced[r, idx], cfg) / P)
        counts = torch.tensor([w.numel() for w in winners])
        absr = reduced.abs()
        probe = ((absr >= (gt_use * cfg.probe_ratio)[:, None])
                 & (reduced != 0)).sum(1)
        total = counts.sum().to(dev)
        gt_next = _newton(gt_use, total.expand(P), probe.sum().expand(P), k,
                          cfg.target_k(cfg.global_k_target),
                          cfg.band_hi_global, cfg)
        vol_b = 2 * counts + 2 * (counts.sum() - counts)

    # residual: acc but at the global winners
    winner = (result != 0)[None, :]
    if cfg.wire_dtype == "float32":
        residual = torch.where(winner, torch.zeros_like(acc), acc)
    else:
        quant = acc - _wire(acc, cfg)
        residual = torch.where(winner, torch.where(sent_mask, quant,
                                                   torch.zeros_like(acc)), acc)
        residual = residual + torch.where(winner & (reduced != 0),
                                          reduced - _wire(reduced, cfg),
                                          torch.zeros_like(acc))
    vol = (vol_a + vol_b).float()
    wire = float(vol[0]) * 0.5 * cfg.wire_pair_bytes
    nxt = {"step": step + 1, "lt": lt_next, "gt": gt_next, "drift": drift,
           "last_exact_lt": last_exact, "bounds": bounds,
           "residual": residual}
    return result, nxt, wire
