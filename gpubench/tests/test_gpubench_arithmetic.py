"""The benchmark's arithmetic on hand-worked numbers: kernel bytes and
roofline shares, model FLOPs and ``mfu_pct``, the trace reduction, the
check's numbers."""

from __future__ import annotations

import json
import math

import pytest
import torch

from gpubench import flops, harness, judge, kernels, peaks, trace
from gpubench.harness import ReadContext
from gpubench.reference import exchange_oktopk as ref_oktopk
from gpubench.registry import Registry
from gpubench.tests import tiny

REG = Registry()
N_BERT, N_VGG = 110_106_428, 14_728_266


def _config(name):
    return tiny.load("configs", name)


def _workload(name):
    return tiny.load("workloads", name)


def test_kernel_bytes_by_hand():
    # K1: grad, residual read and acc written (12 bytes an element), two
    # thresholds read (8), two counts and 256 bins written (4 x 258)
    assert kernels.k1_bytes(1000) == 12_000 + 8 + 1032
    # the pack: x and t read (4n + 4), R + 1 bounds, values and indices
    # [R, cap] (8 R cap), R counts
    assert kernels.compaction_bytes(1000, 4, 50, True) == (
        4000 + 4 + 20 + 1600 + 16)
    assert kernels.compaction_bytes(1000, 1, 50, False) == 4000 + 4 + 400 + 4


def test_bert_caps_are_the_programs_forms():
    cfg = ref_oktopk.SparseConfig(n=N_BERT, workers=4, density=0.01,
                                  local_recompute_every=128,
                                  global_recompute_every=128)
    assert cfg.k == 1_101_064
    # PERF.md's kernel table: bert_pack_a cap 550,540, bert_select_b
    # cap 1,101,072
    assert cfg.cap_pair == 550_540
    assert cfg.cap_exact == 1_101_072
    assert cfg.cap_gather == int(2.5 * 1_101_064 / 4) + 8
    k1, comp = kernels.oktopk_calls(cfg, 0)
    assert k1 == [12 * N_BERT + 8 + 1032]
    assert comp == [kernels.compaction_bytes(N_BERT, 4, 550_540, True),
                    kernels.compaction_bytes(N_BERT, 1, 1_101_072, False)]
    _, comp5 = kernels.oktopk_calls(cfg, 5)
    assert comp5[1] == kernels.compaction_bytes(N_BERT, 1, cfg.cap_gather,
                                                False)


def _summary(kernel_times):
    return {"busy_s": 0.5, "window_s": 1.0,
            "kernels": {name: {"seconds": s, "count": c}
                        for name, (s, c) in kernel_times.items()},
            "device_ops": [], "idle_gaps": []}


def _ctx(summary, sparse, steps, samples=0.0, fps=0.0, clocked=()):
    return ReadContext(config={}, workload={}, steps=list(clocked),
                       trace=summary, profiled_steps=steps, exchange=sparse,
                       samples_per_s=samples, wire_bytes_per_step=0.0,
                       flops_per_sample=fps, peak_flops=67e12)


def test_rooflines_by_hand():
    sparse = ref_oktopk.SparseConfig(n=1_000_000, workers=4, density=0.02)
    steps = [33, 34]                   # not a recompute step (every 32)
    k1 = 12e6 + 8 + 1032
    # 8 sweeps of k1 bytes in 8 * k1 / 3.35e12 s would be 100%
    t = 8 * k1 / peaks.HBM_BYTES_PER_S
    summ = _summary({"fs_zero(int*)": (0.0, 8),
                     "fs_sweep(float const*, float const*)": (2 * t, 8),
                     "cp_prefill(float*)": (0.0, 16),
                     "void cp_compact(float const*)": (1e-3, 16)})
    read = REG.reader("k1_roofline_pct")
    assert read(_ctx(summ, sparse, steps)) == pytest.approx(50.0)
    pack = kernels.compaction_bytes(10 ** 6, 4, sparse.cap_pair, True)
    select = kernels.compaction_bytes(10 ** 6, 1, sparse.cap_gather, False)
    want = 100 * 8 * (pack + select) / peaks.HBM_BYTES_PER_S / 1e-3
    got = REG.reader("compaction_roofline_pct")(_ctx(summ, sparse, steps))
    assert got == pytest.approx(want)
    # another count of launches: the path changed, nothing to read
    summ["kernels"]["fs_sweep(float const*, float const*)"]["count"] = 7
    assert read(_ctx(summ, sparse, steps)) is None
    assert read(_ctx(None, sparse, steps)) is None
    assert read(_ctx(summ, None, steps)) is None


def test_mfu_and_idle_by_hand():
    # busy 0.5 s over 4 profiled steps: 125 ms a step; the window's
    # periods 150, 160, 200 (an exact step) ms, the last step none
    clocked = [{"period_ms": p} for p in (150.0, 200.0, 160.0, None)]
    ctx = _ctx(_summary({}), None, [40, 41, 42, 43], samples=300.0,
               fps=85.5e9, clocked=clocked)
    assert REG.reader("mfu_pct")(ctx) == pytest.approx(
        100 * 85.5e9 * 300 / 67e12)
    assert REG.reader("device_idle_pct")(ctx) == pytest.approx(
        100 * (1 - 125 / 160))
    # the trace's own window (1 s, 50% idle) does not enter
    assert REG.reader("device_idle_pct")(_ctx(_summary({}), None, [1])) is None
    assert REG.reader("device_idle_pct")(_ctx(None, None, [1],
                                              clocked=clocked)) is None


def test_only_steady_steps_are_profiled():
    from gpubench.reference import exchange_dense
    cfg = ref_oktopk.SparseConfig(n=1000, workers=4, density=0.02,
                                  local_recompute_every=32,
                                  global_recompute_every=32,
                                  repartition_every=64)
    steady = [s for s in range(130) if ref_oktopk.steady(cfg, s)]
    assert 0 not in steady and 32 not in steady and 64 not in steady
    assert 128 not in steady and len(steady) == 130 - 5
    assert all(exchange_dense.steady(None, s) for s in range(5))


def test_bert_base_flops_by_hand():
    H, FF, T, L, V = 768, 3072, 128, 12, 30522
    per_token = L * (2 * 4 * H * H + 2 * 2 * H * FF + 2 * 2 * T * H)
    per_token += 2 * H * H + 2 * H * V          # the MLM head
    per_seq = per_token * T + 2 * H * H + 2 * H * 2   # pooler, NSP
    got = flops.forward_flops(_config("bert-base"),
                              _workload("bert-base.oktopk.gb256"),
                              REG.generator("mlm_nsp"), 2)
    assert got == 2 * per_seq
    assert flops.per_sample(_config("bert-base"),
                            _workload("bert-base.oktopk.gb256"),
                            REG.generator("mlm_nsp")) == 3 * per_seq
    assert 3 * per_seq == 85_500_896_256


def test_vgg16_flops_by_hand():
    cfg = _config("vgg16-cifar10")
    want, c, hw = 0, 3, 32
    for v in cfg["model"]["layers"]:
        if v == "M":
            hw //= 2
        else:
            want += 2 * 9 * c * v * hw * hw
            c = v
    want += 2 * 512 * 10
    got = flops.forward_flops(cfg, _workload("vgg16-cifar10.dense.gb2048"),
                              REG.generator("images"), 4)
    assert got == 4 * want


def test_parameter_counts_are_the_configurations():
    for name in ("bert-base", "vgg16-cifar10"):
        cfg = _config(name)
        fam = harness.ref_train.family(cfg["family"])
        n = sum(math.prod(s) for _, s, _ in fam.leaf_table(cfg["model"]))
        assert n == cfg["n_params"]
    assert _config("bert-base")["n_params"] == N_BERT
    assert _config("vgg16-cifar10")["n_params"] == N_VGG


def test_trace_summary_by_hand():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10,
           "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 55,
           "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "outer", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 5, "dur": 15},
          {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 40, "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 90,
           "dur": 20},
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 200}]
    s = trace.summarize(ev)
    # busy [0, 20] + [40, 50] + [90, 110]: 50 us of the window [0, 110]
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["window_s"] == pytest.approx(110e-6)
    assert s["kernels"]["k_a"] == {"seconds": pytest.approx(20e-6),
                                   "count": 2}
    # gaps [20, 40] (middle 30: inside aten::mm) and [50, 90] (middle 70:
    # only "outer")
    assert {k: pytest.approx(v) for k, v in s["idle_gaps"]} == {
        "outer": 40e-6, "aten::mm": 20e-6}
    assert [k for k, _ in s["device_ops"]] == ["k_a", "set", "k_b"]
    device_only = trace.summarize([e for e in ev if e["cat"] != "cpu_op"
                                   and e["name"] != "outer"])
    assert device_only["idle_gaps"] == []
    assert device_only["busy_s"] == s["busy_s"]
    assert trace.summarize(ev[:3]) is None


def test_norm_gap_by_hand():
    table = [("a", (2,), None), ("b", (2,), None), ("c", (1,), None)]
    ref = torch.tensor([3.0, 4.0, 0.0, 1.0, 0.0])       # norms 5, 1, 0
    prog = torch.tensor([3.0, 4.0, 0.0, 2.0, 0.5])      # norms 5, 2, 0.5
    # the median of the nonzero norms (5, 1) is 1 (torch takes the lower)
    assert judge.norm_gap(prog, ref, table) == pytest.approx(1.0)
    keep = torch.tensor([True, False, True])
    assert judge.norm_gap(prog, ref, table, keep) == pytest.approx(0.5)
    assert judge.norm_gap(ref, ref, table) == 0.0


def test_numbers_and_verdict():
    table = [("a", (2,), None)]
    w0 = torch.zeros(2)
    side = {"losses": [2.0, 1.0], "wire_bytes": [100.0, 50.0],
            "received": torch.tensor([1.0, 0.0]),
            "params": torch.tensor([0.5, 0.5])}
    other = dict(side, losses=[2.0, 1.1], wire_bytes=[100.0, 49.0])
    assert judge.numbers(dict(side, wire_bytes=[101.0, 50.0]), side, w0,
                         table)["wire_gap_first"] == pytest.approx(0.01)
    nums = judge.numbers(other, side, w0, table)
    assert nums["loss_gap"] == pytest.approx(0.1)
    assert nums["wire_gap"] == pytest.approx(0.02)
    assert nums["grad_gap"] == 0.0 and nums["update_gap"] == 0.0
    assert nums["grad_gap_median"] == 0.0
    assert nums["loss_gap_first"] == 0.0 and nums["wire_gap_first"] == 0.0
    lim = {"loss_gap": 0.2, "loss_gap_first": 0.0, "grad_gap": 0.0,
           "grad_gap_median": 0.0, "update_gap": 0.0,
           "update_gap_median": 0.0, "wire_gap": 0.05,
           "wire_gap_first": 0.0}
    assert judge.verdict(nums, lim)
    assert not judge.verdict(dict(nums, wire_gap=math.nan), lim)
    assert not judge.verdict(nums, dict(lim, loss_gap=0.05))
    # a number without a limit is not compared; one limit at least
    assert judge.verdict(nums, dict(lim, loss_gap=None))
    with pytest.raises(ValueError):
        judge.verdict(nums, dict.fromkeys(lim))


def test_median_gap_by_hand():
    table = [("a", (1,), None), ("b", (1,), None), ("c", (1,), None),
             ("d", (1,), None)]
    ref = torch.tensor([1.0, 2.0, 4.0, 0.0])
    prog = torch.tensor([1.1, 2.0, 8.0, 3.0])
    # gaps over max(norm, median of nonzero norms = 2): 0.05, 0, 1, and
    # leaf d (reference norm 0) left out of the median
    assert judge.median_gap(prog, ref, table) == pytest.approx(0.05)
    keep = torch.tensor([False, True, True, True])
    assert judge.median_gap(prog, ref, table, keep) == 0.0


def test_seeds_and_weights():
    assert harness.derive(7, "a") == harness.derive(7, "a")
    assert harness.derive(7, "a") != harness.derive(7, "b")
    assert 0 <= harness.derive(2 ** 33 + 5, "weights") < 2 ** 63
    table = [("k", (400, 50), ("normal", 0.5)), ("b", (50,), ("zeros",)),
             ("s", (50,), ("ones",))]
    w = harness.make_weights(table, 2 ** 31 + 11, "cpu")
    assert torch.equal(w, harness.make_weights(table, 2 ** 31 + 11, "cpu"))
    assert float(w[:20000].std()) == pytest.approx(0.5, rel=0.05)
    assert torch.equal(w[20000:20050], torch.zeros(50))
    assert torch.equal(w[20050:], torch.ones(50))


def test_limits_sit_between_their_readings():
    """Each limit lies above the lower reading and below the upper one
    (the workload files carry both, as PERF.md gives them); a number
    without a limit is not compared; every cell compares some."""
    for w in REG.bench["workloads"]:
        wl = REG.workload(w["name"])
        assert set(wl["limits"]) == set(judge.NUMBERS) == set(
            wl["readings"])
        assert any(v is not None for v in wl["limits"].values())
        for k in judge.NUMBERS:
            lo, hi = wl["readings"][k]
            lim = wl["limits"][k]
            if lim is None:     # not compared (PERF.md gives why)
                continue
            assert hi is not None and lo < lim < hi, (w["name"], k)


def test_benchmark_json_is_valid_json():
    json.loads((tiny.HOME.parent / "BENCHMARK.json").read_text())
