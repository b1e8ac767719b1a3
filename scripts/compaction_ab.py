#!/usr/bin/env python3
"""The compaction and fused select kernels of this tree against those of
an earlier checkout whose compaction is the three-pass design (count
pass, one-block scan, write pass, fed the fused select kernel's
per-1024-element tile survivor counts), in one process on one GPU.

Both designs are built from their own sources with this tree's nvcc
flags, checked bit-equal to this tree's plain versions on the main
path's inputs (``chip_smoke.py``'s), then timed in the forms the main
path calls them, in the order new, old, old, new. Each time is printed
as a JSON line with ``chip_smoke.timing``'s keys (``call_ms``: CUDA events
around one call, the kernels line's ``ms``; ``device_ms``: profiler
device time per call), then the
card's name and power limit. Needs a CUDA device. Example:

    mkdir -p _baseline && git archive <commit> | tar -x -C _baseline
    python3 scripts/compaction_ab.py _baseline
"""

from __future__ import annotations

import ctypes as C
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OLD_FUSED_LAUNCHES = {"fs_zero": 1, "fs_sweep": 1}
OLD_PACK_LAUNCHES = {"cp_scan": 1, "cp_write": 1}      # fed tile counts
OLD_SELECT_LAUNCHES = {"cp_count": 1, "cp_scan": 1, "cp_write": 1}


class ThreePass:
    """The earlier checkout's kernels, through its own C interfaces."""

    def __init__(self, root: Path):
        from oktopk_tpu_torch.ops import _build
        self.b = _build
        out = _build.BUILD_DIR / "three_pass"
        out.mkdir(parents=True, exist_ok=True)
        sigs = {
            "compaction": ("oktopk_compact", [
                C.c_void_p, C.c_int64, C.c_void_p, C.c_void_p, C.c_int,
                C.c_int] + [C.c_void_p] * 8),
            "fused_select": ("oktopk_fused_select", [
                C.c_void_p, C.c_void_p, C.c_void_p, C.c_int64] +
                [C.c_void_p] * 5),
        }
        procs = {nm: subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{nm}.so"),
             str(root / "oktopk_tpu_torch" / "csrc" / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for nm, src in _build.SOURCES.items()}
        self.fns = {}
        for nm, p in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"{nm}: nvcc exit {p.returncode}\n{log}")
            fn_name, argtypes = sigs[nm]
            fn = getattr(C.CDLL(str(out / f"{nm}.so")), fn_name)
            fn.argtypes, fn.restype = argtypes, C.c_int
            self.fns[nm] = fn

    def fused(self, g, r, t, tp):
        """(acc, per-1024-tile survivor counts, stats)."""
        import torch
        b, n = self.b, g.numel()
        acc = torch.empty_like(g)
        tiles = torch.empty((-(-n // 1024),), dtype=torch.int32,
                            device=g.device)
        stats = torch.empty((258,), dtype=torch.int32, device=g.device)
        b.check(self.fns["fused_select"](
            b.ptr(g), b.ptr(r), b.ptr(acc), n, b.ptr(t), b.ptr(tp),
            b.ptr(tiles), b.ptr(stats), b.stream_handle(g.device)),
            "three-pass fused select")
        return acc, tiles, stats

    def compact(self, x, t, bnd, R, cap, tiles=None):
        """(values, indices, counts); ``tiles`` feeds the tile counts."""
        import torch
        b, n, dev = self.b, x.numel(), x.device
        nt = -(-n // 1024)
        values = torch.empty((R, cap), dtype=torch.float32, device=dev)
        indices = torch.empty((R, cap), dtype=torch.int32, device=dev)
        counts = torch.empty((R,), dtype=torch.int32, device=dev)
        s = torch.empty((2 * nt + R + 2,), dtype=torch.int32, device=dev)
        b.check(self.fns["compaction"](
            b.ptr(x), n, b.ptr(t), b.ptr(bnd), R, cap, b.ptr(tiles),
            b.ptr(s[:nt]), b.ptr(s[nt:2 * nt + 1]), b.ptr(s[2 * nt + 1:]),
            b.ptr(values), b.ptr(indices), b.ptr(counts),
            b.stream_handle(dev)), "three-pass compaction")
        return values, indices, counts


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("compaction_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.ops import _build, compaction, fused_select

    dev = torch.device("cuda", 0)
    _build.build_all()
    old = ThreePass(Path(sys.argv[1]))
    n, P = cs.N_VGG16, 4
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.02)
    cap = cfg.cap_pair
    bnd = cs.region_bounds(n, dev)
    regimes = cs.make_regimes(n, dev, [int(b) // 1024 for b in bnd[1:-1]])
    for name, g, r, t in regimes:
        # the old design is run right, or its times mean nothing
        tt = torch.full((), t, dtype=torch.float32, device=dev)
        tp = tt * 1.25
        ref = fused_select.fused_select_plain(g, r, tt, tp)
        acc, tiles, stats = old.fused(g, r, tt, tp)
        cs.bits_equal(acc, ref.acc, f"{name}: three-pass acc")
        cs.bits_equal(stats[2:], ref.hist, f"{name}: three-pass hist")
        cs.triples_equal(
            old.compact(acc, tt, bnd, P, cap, tiles),
            compaction.pack_by_region_plain(acc, tt, bnd, P, cap),
            f"{name}: three-pass pack")

    _, g, r, t = regimes[0]
    tt = torch.full((), t, dtype=torch.float32, device=dev)
    tp = tt * 1.25
    st = fused_select.fused_select_stage(g, r, tt, tp)
    tiles = old.fused(g, r, tt, tp)[1]
    xb, tb = cs.phase_b_input(n, cfg.cap_exact, dev)
    v, i, c = old.compact(xb, tb, None, 1, cfg.cap_exact)
    cs.triples_equal((v[0], i[0], c[0]), compaction.select_by_threshold_plain(
        xb, tb, cfg.cap_exact), "three-pass select")
    forms = {
        "fused_select": (
            (lambda: fused_select.fused_select_stage(g, r, tt, tp),
             cs.K1_LAUNCHES),
            (lambda: old.fused(g, r, tt, tp), OLD_FUSED_LAUNCHES)),
        "pack_a": (
            (lambda: fused_select.fused_pack_finalize(st, bnd, P, cap),
             cs.COMPACTION_LAUNCHES),
            (lambda: old.compact(st.acc, tt, bnd, P, cap, tiles),
             OLD_PACK_LAUNCHES)),
        "select_b": (
            (lambda: compaction.select_by_threshold(xb, tb, cfg.cap_exact),
             cs.COMPACTION_LAUNCHES),
            (lambda: old.compact(xb, tb, None, 1, cfg.cap_exact),
             OLD_SELECT_LAUNCHES)),
    }
    for nm, (new, three) in forms.items():
        runs = {"one_pass": [], "three_pass": []}
        for which, (fn, expect) in (("one_pass", new), ("three_pass", three),
                                    ("three_pass", three), ("one_pass", new)):
            runs[which].append(cs.timing(fn, expect))
        rec = {"form": nm}
        for which, rs in runs.items():
            rec[which] = {k: statistics.mean(x[k] for x in rs)
                          for k in ("device_ms", "call_ms",
                                    "launches_per_call")}
            rec[which]["device_ms_runs"] = [x["device_ms"] for x in rs]
            rec[which]["call_ms_runs"] = [x["call_ms"] for x in rs]
        cs.emit(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
