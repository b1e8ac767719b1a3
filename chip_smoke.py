#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds its kernels and trains on
one NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives ``oktopk_tpu_torch`` only (no JAX, nothing of ``oktopk_tpu``)
and prints one JSON line per phase:

1. build    — both CUDA kernels compiled by nvcc for sm_90a from
              ``oktopk_tpu_torch/csrc/``, one nvcc per source, in parallel;
2. kernels  — the fused select kernel and the compaction kernel at the
              VGG-16 flat size n = 14,728,266, on seeded inputs in the
              fast, repair and wide regimes of the TPU kernels they
              replace, with R = 4 regions whose boundaries straddle
              1024-element tiles (one inside an overflowing tile): each
              held bit-equal against its plain PyTorch version on the
              card, then timed with CUDA events (median of 25);
3. allreduce — three oktopk steps at n = 2^20, P = 4 on the card against
              the plain path on the CPU from the same state: reduced
              result and residual bit-equal, thresholds within 64 ulps;
4. trainer  — VGG-16 at full width, P = 4 workers stacked on the card,
              global batch 64, density 0.02, one dense warmup step then
              five oktopk steps (local_recompute_every=1,
              global_recompute_every=4, threshold "bisect"), launch
              counters set to 0 just before and read just after.

Then the ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure raises, prints
no result and exits non-zero, as does a machine without CUDA.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

N_VGG16 = 14728266
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median of ``iters`` single-call CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bits_equal(a, b, what: str) -> float:
    """Raise unless ``a`` and ``b`` are bit-identical; returns the largest
    absolute difference (0.0 when they are)."""
    import torch
    a, b = a.detach(), b.detach()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(a.shape)}/{a.dtype} vs "
                             f"{tuple(b.shape)}/{b.dtype}")
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    bad = int((a != b).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} elements differ "
                             f"(max abs err {err})")
    return err


def max_ulps(a, b) -> int:
    import torch
    ai = a.detach().float().cpu().view(torch.int32).long()
    bi = b.detach().float().cpu().view(torch.int32).long()
    return int((ai - bi).abs().max())


def make_regimes(n: int, dev, straddle_tiles):
    """(name, grad, residual, threshold) at ~2% density: no 1024-element
    tile over 128 survivors (fast); 1..nb/8 such tiles (the TPU's repair
    regime); more than nb/8 (its wide regime). ``straddle_tiles`` (the
    tiles holding region boundaries) overflow in both of the latter."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nt = -(-n // 1024)
    base = torch.randn(n, generator=gen, device=dev)
    res = 0.05 * torch.randn(n, generator=gen, device=dev)
    t = 2.33
    out = [("fast", base, res, t)]
    for name, ntile in (("repair", nt // 16), ("wide", nt // 4)):
        g = base.clone()
        tiles = torch.randperm(nt - 1, generator=gen, device=dev)[:ntile]
        tiles = torch.unique(torch.cat([tiles, torch.tensor(
            straddle_tiles, dtype=tiles.dtype, device=dev)]))
        idx = (tiles[:, None] * 1024
               + torch.arange(1024, device=dev)[None, :]).reshape(-1)
        g[idx] = g[idx] * 4.0
        out.append((name, g, res, t))
    return out


def tile_overflow(x, t, n):
    import torch
    nt = -(-n // 1024)
    m = torch.nn.functional.pad((x.abs() >= t).int(), (0, nt * 1024 - n))
    raw = m.view(nt, 1024).sum(1)
    return int((raw > 128).sum()), nt


def phase_build():
    from oktopk_tpu_torch.ops import _build
    secs = _build.build_all()
    for nm in _build.SOURCES:
        _build.library(nm)
    ptxas = {nm: [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
             for nm, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": secs, "arch": "sm_90a",
          "sources": sorted(_build.SOURCES.values()), "ptxas": ptxas})


def phase_kernels(dev):
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.ops import compaction, fused_select

    n = N_VGG16
    P = 4
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.02)
    cap = cfg.cap_pair
    nt = -(-n // 1024)
    # region boundaries off the 1024-element tile grid; the tiles holding
    # them overflow in the repair and wide inputs
    bnd = torch.tensor([0, n // 4 + 517, n // 2 + 3, 3 * n // 4 + 1023, n],
                       dtype=torch.int32, device=dev)
    regimes = make_regimes(n, dev, [int(b) // 1024 for b in bnd[1:-1]])
    timings = {}
    errs = {"fused_select": 0.0, "compaction": 0.0}
    for name, g, r, t in regimes:
        tt = torch.full((), t, dtype=torch.float32, device=dev)
        tp = tt * 1.25
        st = fused_select.fused_select_stage(g, r, tt, tp)
        ref = fused_select.fused_select_plain(g, r, tt, tp)
        for f in ("acc", "local_count", "probe_count", "hist",
                  "tile_counts"):
            errs["fused_select"] = max(errs["fused_select"], bits_equal(
                getattr(st, f), getattr(ref, f), f"{name}: {f}"))
        novf, _ = tile_overflow(st.acc, t, n)
        got = fused_select.fused_pack_finalize(st, bnd, P, cap)
        want = compaction.pack_by_region_plain(st.acc, tt, bnd, P, cap)
        checks = [("pack", got, want),
                  ("pack (own count pass)",
                   compaction.pack_by_region(st.acc, tt, bnd, P, cap), want),
                  ("select",
                   compaction.select_by_threshold(st.acc, tt,
                                                  cfg.cap_gather),
                   compaction.select_by_threshold_plain(st.acc, tt,
                                                        cfg.cap_gather))]
        for what, gs, ws in checks:
            for f, a, b in zip(("values", "indices", "counts"), gs, ws):
                errs["compaction"] = max(errs["compaction"], bits_equal(
                    a, b, f"{name}: {what} {f}"))
        got = checks[0][1]
        torch.cuda.synchronize()
        rec = {"phase": "kernels", "regime": name, "n": n,
               "overflowing_tiles": novf, "tiles": nt,
               "local_count": int(st.local_count),
               "counts": [int(c) for c in got[2].reshape(-1)],
               "bit_equal": True}
        if name == "fast":
            # the main path's calls: the fused sweep, then the phase-(a)
            # pack fed the sweep's tile counts
            timings["fused_select"] = (
                cuda_time_ms(lambda: fused_select.fused_select_stage(
                    g, r, tt, tp)),
                cuda_time_ms(lambda: fused_select.fused_select_plain(
                    g, r, tt, tp)),
                None)
            acc = st.acc

            def library_call():
                idx = torch.nonzero(acc.abs() >= tt).squeeze(1)
                return acc[idx], idx
            mask_ms = cuda_time_ms(library_call)
            timings["compaction"] = (
                cuda_time_ms(lambda: fused_select.fused_pack_finalize(
                    st, bnd, P, cap)),
                cuda_time_ms(lambda: compaction.pack_by_region_plain(
                    acc, tt, bnd, P, cap)),
                mask_ms)
            rec["survivors"] = int(st.local_count)
        emit(rec)
    return timings, errs, n, cap, P


def kernel_bounds(n: int, cap: int, R: int):
    nt = -(-n // 1024)
    # each input read once, each output written once
    fused_bytes = 4 * n * 3 + 4 * nt + 4 * (2 + 256) + 8
    comp_bytes = 4 * n + 4 * nt + 4 * (R + 1) + 4 + 8 * R * cap + 4 * R
    return {"fused_select": fused_bytes / HBM_BYTES_PER_S * 1e3,
            "compaction": comp_bytes / HBM_BYTES_PER_S * 1e3}


def phase_allreduce(dev):
    """Three oktopk steps at n = 2^20, P = 4: the card (both kernels) from
    the state the CPU (plain versions) reached, compared step by step."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.collectives.registry import get_algorithm
    from oktopk_tpu_torch.collectives.state import SparseState, init_state
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig

    P, n = 4, 1 << 20
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.02, warmup_steps=0,
                       local_recompute_every=2, global_recompute_every=2,
                       repartition_every=3, threshold_method="hist")
    algo = get_algorithm("oktopk", warmup=False)
    comm = StackedComm(P)
    rng = np.random.RandomState(SEED)
    base = rng.randn(P, n).astype(np.float32)
    state = init_state(cfg, P, "cpu")
    worst = 0
    for i in range(3):
        g = base + 0.3 * rng.randn(P, n).astype(np.float32)
        gs = SparseState.from_numpy(state.to_numpy(), dev)
        out_c, state2 = algo(torch.from_numpy(g), state, cfg, comm)
        out_g, gs2 = algo(torch.from_numpy(g).to(dev), gs, cfg, comm)
        bits_equal(out_g.cpu(), out_c, f"allreduce step {i}: result")
        a, b = gs2.to_numpy(), state2.to_numpy()
        for f in ("residual", "boundaries", "last_volume", "wire_bytes",
                  "last_local_count", "last_global_count", "step"):
            bits_equal(torch.from_numpy(a[f]), torch.from_numpy(b[f]),
                       f"allreduce step {i}: {f}")
        for f in ("local_threshold", "global_threshold", "drift",
                  "last_exact_lt"):
            u = max_ulps(torch.from_numpy(a[f]), torch.from_numpy(b[f]))
            worst = max(worst, u)
            if u > 64:
                raise AssertionError(f"allreduce step {i}: {f} {u} ulps")
        state = state2
    emit({"phase": "allreduce", "n": n, "P": P, "steps": 3,
          "result_bit_equal": True, "threshold_max_ulps": worst})


def phase_trainer(dev):
    import numpy as np
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.ops import compaction, fused_select
    from oktopk_tpu_torch.train.trainer import Trainer

    P, gbs = 4, 64
    cfg = TrainConfig(dnn="vgg16", batch_size=gbs // P, lr=0.1,
                      density=0.02, num_workers=P, seed=SEED)
    algo = OkTopkConfig(warmup_steps=1, local_recompute_every=1,
                        global_recompute_every=4)
    trainer = Trainer(cfg, algo_cfg=algo, device=dev)
    if trainer.algo_cfg.n != N_VGG16:
        raise AssertionError(f"VGG-16 has {trainer.algo_cfg.n} parameters")
    rng = np.random.RandomState(SEED)
    batches = [synthetic_batch("vgg16", gbs, rng) for _ in range(6)]
    torch.cuda.synchronize()
    compaction.LAUNCHES = 0
    fused_select.LAUNCHES = 0
    steps, times = [], []
    for s, b in enumerate(batches):
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rec = {k: float(v) for k, v in m.items()}
        rec.update(step=s + 1, ms=times[-1],
                   collective="dense" if s < algo.warmup_steps else "oktopk")
        steps.append(rec)
        emit({"phase": "trainer", **rec})
    launches = {"fused_select": fused_select.LAUNCHES,
                "compaction": compaction.LAUNCHES}
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for nm, c in launches.items():
        if c <= 0:
            raise AssertionError(f"{nm} kernel never launched on the path")
    for p in trainer.params:
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("non-finite parameter after training")
    sparse = [r for r in steps if r["collective"] == "oktopk"]
    emit({"phase": "trainer_summary", "model": "vgg16", "n": N_VGG16,
          "workers": P, "global_batch": gbs, "steps": len(steps),
          "losses": losses, "median_step_ms": statistics.median(times),
          "median_oktopk_step_ms": statistics.median(
              r["ms"] for r in sparse[1:]),
          "launches": launches,
          "launches_per_oktopk_step": {k: v / len(sparse)
                                       for k, v in launches.items()}})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import oktopk_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    phase_build()
    timings, errs, n, cap, R = phase_kernels(dev)
    phase_allreduce(dev)
    launches = phase_trainer(dev)
    bounds = kernel_bounds(n, cap, R)
    info = {
        "fused_select": ("cuda", "oktopk_tpu_torch/csrc/fused_select.cu",
                         "oktopk_tpu/ops/fused_select.py:64"),
        "compaction": ("cuda", "oktopk_tpu_torch/csrc/compaction.cu",
                       "oktopk_tpu/ops/compaction.py:160"),
    }
    kernels = []
    for nm, (route, src, rep) in info.items():
        ms, plain_ms, lib_ms = timings[nm]
        entry = {"name": nm, "route": route, "source": src, "replaces": rep,
                 "launches": launches[nm], "max_abs_err": errs[nm],
                 "bit_equal": errs[nm] == 0.0,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[nm],
                 "bound_by": "bytes", "library_ms": lib_ms}
        if nm == "compaction":
            entry["also_replaces"] = "oktopk_tpu/ops/compaction.py:229"
        kernels.append(entry)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
