"""oktopk's combine phase (``ops/combine.py``), held on the CPU.

- The plain versions against the composition oktopk ran before the
  combine op (``ops/select.py::scatter_rows``, the winner mask
  ``result != 0``, the sent mask ``|acc| >= lt``,
  ``collectives/wire.py::residual_after_winners``), bit-equal (int32
  view), both wires, W in {1, 4}, on edge inputs: phase-(a) indices that
  collide across rows, the sentinel n (with a value behind it), -0.0 at a
  non-winner, NaN and infinities, subnormals, |acc| exactly at lt, bf16
  ties, winners this worker did not send, reduced != 0 at non-winners,
  and n not a multiple of 4.
- ``kernel_rule``: a numpy transcription of the kernels' arithmetic
  (``csrc/combine.cu``'s ``cb_scatter`` and ``cb_elem``), held to the
  same results, so the CUDA source's rule is checked where no card is.
- An oktopk step through the op against the same step through the old
  composition: result and residual bit-equal over exact, repartition and
  steady steps, fused and unfused, both wires.

The kernels themselves are held to the plain versions on the card by the
``cuda``-marked test at the end (and ``chip_smoke.py``'s combine phase).
This file imports no JAX, so the card's test runs without it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from oktopk_tpu_torch.collectives import oktopk as oktopk_mod
from oktopk_tpu_torch.collectives import wire
from oktopk_tpu_torch.collectives.registry import get_algorithm
from oktopk_tpu_torch.collectives.state import init_state
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.ops import combine, select

R = 4                      # source rows of either scatter (P = 4)
WIRES = ("float32", "bfloat16")
SUBNORMAL = np.float32(1e-40)


def chip_smoke():
    """``chip_smoke.py`` as a module (it lies outside the package)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bits(t):
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.int32)


def assert_bits(got, want, what):
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)


# ---- inputs ----------------------------------------------------------------

def distinct_rows(rng, n, parts, m, cap):
    """[parts, cap] sorted distinct indices of [0, n), ``m`` a row, padded
    with the sentinel n."""
    idx = np.full((parts, cap), n, np.int32)
    for p in range(parts):
        idx[p, :m] = np.sort(rng.choice(n, m, replace=False))
    return idx


def base_inputs(W, n, rng):
    """acc [W, n], lt [W]; phase (a)'s received rows (every row over the
    whole of [0, n), so indices collide across rows) and phase (b)'s
    gathered rows (indices distinct across rows)."""
    acc = (0.1 * rng.randn(W, n)).astype(np.float32)
    lt = (0.12 * (1.0 + 0.1 * np.arange(W))).astype(np.float32)
    m = n // 6
    r_idx = np.stack([distinct_rows(rng, n, R, m, m + 3) for _ in range(W)])
    r_vals = rng.randn(W, R, m + 3).astype(np.float32)
    owner = rng.permutation(n) % R            # phase (b): one owner each
    capg = n // 8 + 2
    gi = np.full((R, capg), n, np.int32)
    for p in range(R):
        mine = np.flatnonzero(owner == p)
        take = np.sort(rng.choice(mine, min(len(mine), n // 8),
                                  replace=False))
        gi[p, :len(take)] = take
    gv = np.where(gi < n, rng.randn(R, capg), 0.0).astype(np.float32)
    return dict(acc=acc, lt=lt, r_vals=r_vals, r_idx=r_idx,
                gv=np.repeat(gv[None], W, 0), gi=np.repeat(gi[None], W, 0))


def winners(x):
    """The indices row 0 of phase (b) delivers (winners of every worker)."""
    g = x["gi"][0, 0]
    return g[g < x["acc"].shape[1]]


def case_collide(x):
    # one index in every row of phase (a), in an order where the sum
    # depends on it: ((1e8 + 1) - 1e8) + 3 = 3 in float32
    j = 5
    for w in range(x["r_idx"].shape[0]):
        for r, v in enumerate((1e8, 1.0, -1e8, 3.0)):
            row = x["r_idx"][w, r]
            row[row == j] = x["acc"].shape[1]
            row[-1] = j
            x["r_vals"][w, r, -1] = v


def case_sentinel(x):
    # values behind the sentinel must drop; one row all sentinel
    n = x["acc"].shape[1]
    x["r_vals"][x["r_idx"] == n] = 7.0
    x["r_idx"][:, 1] = n
    x["r_vals"][:, 1] = 9.0
    x["gv"][x["gi"] == n] = 5.0


def case_neg_zero(x):
    x["acc"][:, 0::3] = -0.0
    x["r_vals"][:, :, 0::2] = -0.0


def case_nan_inf(x):
    win = winners(x)
    a = x["acc"]
    a[:, 1], a[:, 2], a[:, 3] = np.nan, np.inf, -np.inf
    a[:, win[:3]] = np.array([np.nan, np.inf, -np.inf], np.float32)
    x["r_vals"][:, 0, :3] = np.array([np.nan, np.inf, -np.inf], np.float32)
    x["gv"][:, :, 1] = np.nan
    x["gv"][:, :, 2] = -np.inf


def case_subnormal(x):
    x["acc"][:, 0::2] *= SUBNORMAL
    x["lt"][:] = SUBNORMAL * np.float32(0.12)
    x["r_vals"][:, :, 0::2] *= SUBNORMAL
    x["gv"][:, :, 0::3] *= SUBNORMAL


def case_at_threshold(x):
    win = winners(x)
    for w in range(x["acc"].shape[0]):
        x["acc"][w, win[0::2]] = x["lt"][w]
        x["acc"][w, win[1::2]] = -x["lt"][w]


def case_bf16_ties(x):
    # halfway between bfloat16 neighbours: ties go to the even one
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                     2 ** 20 * (1 + 2 ** -8), 1 + 2 ** -9], np.float32)
    a = x["acc"]
    a[:, :] = np.resize(ties, a.shape[1])[None]
    x["lt"][:] = 0.5
    x["r_vals"][:, :, :] = np.resize(ties, x["r_vals"].shape[2])


def case_not_sent(x):
    # every winner below this worker's lt: it sent none of them
    x["acc"][:] = np.clip(x["acc"], -0.05, 0.05)


def case_reduced_off_winners(x):
    # phase (a) lands everywhere, phase (b) delivers only a few winners
    x["gi"][:, :, 4:] = x["acc"].shape[1]
    x["gv"][:, :, 4:] = 0.0


CASES = {"random": lambda x: None, "collide": case_collide,
         "sentinel": case_sentinel, "neg_zero": case_neg_zero,
         "nan_inf": case_nan_inf, "subnormal": case_subnormal,
         "at_threshold": case_at_threshold, "bf16_ties": case_bf16_ties,
         "not_sent": case_not_sent,
         "reduced_off_winners": case_reduced_off_winners}


def make_case(name, W, n, seed=0):
    x = base_inputs(W, n, np.random.RandomState(seed))
    CASES[name](x)
    return x


def tensors(x, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


# ---- the two ways -----------------------------------------------------------

def old_composition(n, t, cfg):
    """oktopk's combine as it was written before the combine op."""
    reduced = select.scatter_rows(n, t["r_vals"], t["r_idx"])
    result = select.scatter_rows(n, t["gv"], t["gi"])
    winner_mask = result != 0.0
    mask = (t["acc"].abs() >= t["lt"][:, None]
            if cfg.wire_dtype != "float32" else None)
    return reduced, result, wire.residual_after_winners(
        t["acc"], winner_mask, mask, reduced, cfg)


def through_op(n, t, cfg):
    reduced = combine.scatter_rows(n, t["r_vals"], t["r_idx"])
    result = combine.scatter_rows(n, t["gv"], t["gi"])
    return reduced, result, combine.residual_after_winners(
        t["acc"], t["lt"], reduced, result, cfg)


def bf16_round(x):
    """float32 -> bfloat16 (nearest, ties to even) -> float32, on bits."""
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), out)


def kernel_rule(n, x, bf16):
    """``cb_scatter`` and ``cb_elem`` of ``csrc/combine.cu`` in numpy (as
    on the CPU: the card's float atomics in ``cb_scatter``, like
    ``scatter_add_``'s there, also flush subnormal sums to zero)."""
    def scatter(vals, idx):
        W = vals.shape[0]
        out = np.zeros((W, n), np.float32)
        for r in range(vals.shape[1]):          # one launch per row
            for w in range(W):
                keep = (idx[w, r] >= 0) & (idx[w, r] < n)
                out[w, idx[w, r][keep]] += vals[w, r][keep]
        return out
    with np.errstate(invalid="ignore", over="ignore"):
        reduced = scatter(x["r_vals"], x["r_idx"])
        result = scatter(x["gv"], x["gi"])
        a, t = x["acc"], x["lt"][:, None]
        win = result != 0
        if not bf16:
            return reduced, result, np.where(win, np.float32(0), a)
        zero = np.float32(0)
        res = np.where(win, np.where(np.abs(a) >= t, a - bf16_round(a),
                                     zero), a)
        comp = np.where(win & (reduced != 0), reduced - bf16_round(reduced),
                        zero)
        return reduced, result, (res + comp).astype(np.float32)


def assert_same_floats(got, want, what):
    """Bit-equal off NaN, NaN where NaN (numpy and PyTorch may give a NaN
    other payloads)."""
    g = got.detach().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(g), nan, err_msg=what)
    np.testing.assert_array_equal(g[~nan].view(np.int32),
                                  want[~nan].view(np.int32), err_msg=what)


@pytest.mark.parametrize("n", [256, 203])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("wire_dtype", WIRES)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_combine_matches_the_old_composition(case, wire_dtype, W, n):
    x = make_case(case, W, n)
    cfg = OkTopkConfig(n=n, num_workers=R, wire_dtype=wire_dtype)
    got = through_op(n, tensors(x), cfg)
    want = old_composition(n, tensors(x), cfg)
    for nm, g, w in zip(("reduced", "result", "residual"), got, want):
        assert g.shape == (W, n)
        assert_bits(g, w, f"{case}: {nm}")
    for nm, g, w in zip(("reduced", "result", "residual"), got,
                        kernel_rule(n, x, wire_dtype != "float32")):
        assert_same_floats(g, w, f"{case}: kernel rule, {nm}")


def test_scatter_adds_rows_in_rank_order():
    x = make_case("collide", 4, 203)
    reduced = combine.scatter_rows(203, *(torch.from_numpy(x[k])
                                          for k in ("r_vals", "r_idx")))
    assert (reduced[:, 5] == 3.0).all()      # ((1e8 + 1) - 1e8) + 3


def test_residual_edges_read_as_specified():
    """The cases' points, read off the residual under the bf16 wire."""
    n = 256
    cfg = OkTopkConfig(n=n, num_workers=R, wire_dtype="bfloat16")
    x = make_case("neg_zero", 4, n)
    t = tensors(x)
    _, result, res = through_op(n, t, cfg)
    off = (result == 0) & (t["acc"] == 0)
    assert off.any() and (bits(res)[off.numpy()] == 0).all()   # +0.0
    x = make_case("not_sent", 4, n)
    t = tensors(x)
    reduced, result, res = through_op(n, t, cfg)
    win = (result != 0) & (reduced == 0)
    assert win.any() and (res[win] == 0).all()
    x = make_case("bf16_ties", 1, n)
    t = tensors(x)
    reduced, result, res = through_op(n, t, cfg)
    a = t["acc"]
    rounded = a.to(torch.bfloat16).float()
    assert torch.equal(rounded[0, :3], torch.tensor([1.0, 1 + 2 ** -6,
                                                     -1.0]))
    win = (result != 0) & (reduced == 0)      # all sent: |acc| >= 0.5
    assert win.any() and torch.equal(res[win], (a - rounded)[win])


# ---- oktopk before and after ------------------------------------------------

class _OldCombine:
    """The combine module's place in oktopk, filled by the old
    composition."""
    scatter_rows = staticmethod(select.scatter_rows)

    @staticmethod
    def residual_after_winners(acc, lt, reduced, result, cfg):
        mask = (acc.abs() >= lt[:, None] if cfg.wire_dtype != "float32"
                else None)
        return wire.residual_after_winners(acc, result != 0.0, mask,
                                           reduced, cfg)


def run_oktopk(cfg, grads):
    algo = get_algorithm("oktopk", warmup=False)
    comm = StackedComm(cfg.num_workers)
    st = init_state(cfg, cfg.num_workers, "cpu")
    outs = []
    for g in grads:
        out, st = algo(torch.from_numpy(g), st, cfg, comm)
        outs.append((out, st.residual))
    return outs


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("wire_dtype", WIRES)
def test_oktopk_step_bit_equal_before_and_after(monkeypatch, wire_dtype,
                                                fuse):
    """Steps 0-5: the first (exact, repartition), steady, exact,
    repartition and steady steps."""
    P, n = 4, 4099
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.05, warmup_steps=0,
                       local_recompute_every=2, global_recompute_every=2,
                       repartition_every=3, wire_dtype=wire_dtype,
                       fuse_select=fuse, threshold_method="sort")
    rng = np.random.RandomState(3)
    grads = [rng.randn(P, n).astype(np.float32) for _ in range(6)]
    after = run_oktopk(cfg, grads)
    monkeypatch.setattr(oktopk_mod, "combine", _OldCombine)
    before = run_oktopk(cfg, grads)
    for i, ((ra, sa), (rb, sb)) in enumerate(zip(after, before)):
        assert_bits(ra, rb, f"result, step {i}")
        assert_bits(sa, sb, f"residual, step {i}")
        assert (sa != 0).any() and (ra != 0).any()


def test_cpu_calls_launch_nothing(monkeypatch):
    monkeypatch.setattr(combine, "LAUNCHES", 0)
    x = make_case("random", 4, 203)
    cfg = OkTopkConfig(n=203, num_workers=R, wire_dtype="bfloat16")
    through_op(203, tensors(x), cfg)
    run_oktopk(cfg.replace(n=4099, warmup_steps=0), [
        np.random.RandomState(0).randn(4, 4099).astype(np.float32)])
    assert combine.LAUNCHES == 0


def test_wrappers_refuse_what_they_cannot_serve():
    x = torch.empty((4, 64), device="meta")
    i = torch.empty((4, R, 8), dtype=torch.int32, device="meta")
    cfg = OkTopkConfig(n=64, num_workers=R)
    with pytest.raises(ValueError):
        combine.scatter_rows(64, torch.empty((4, R, 8), device="meta"), i)
    with pytest.raises(ValueError):
        combine.residual_after_winners(x, torch.empty(4, device="meta"),
                                       x, x, cfg)
    with pytest.raises(ValueError):     # shapes
        combine.scatter_rows(64, torch.zeros((4, R, 8)),
                             torch.zeros((4, R, 7), dtype=torch.int32))
    with pytest.raises(ValueError):
        combine.residual_after_winners(torch.zeros(4, 64), torch.zeros(3),
                                       torch.zeros(4, 64),
                                       torch.zeros(4, 64), cfg)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def check_on_card(n, t, cfg, what):
    """Kernels against the plain versions, both on the card."""
    before = combine.LAUNCHES
    reduced = combine.scatter_rows(n, t["r_vals"], t["r_idx"])
    result = combine.scatter_rows(n, t["gv"], t["gi"])
    res = combine.residual_after_winners(t["acc"], t["lt"], reduced, result,
                                         cfg)
    assert combine.LAUNCHES - before == t["r_idx"].shape[1] \
        + t["gi"].shape[1] + 1, what
    assert reduced.is_contiguous() and result.is_contiguous()
    want_red = combine.scatter_rows_plain(n, t["r_vals"], t["r_idx"])
    want_res = combine.scatter_rows_plain(n, t["gv"], t["gi"])
    want = combine.residual_after_winners_plain(t["acc"], t["lt"], want_red,
                                                want_res, cfg)
    torch.cuda.synchronize()
    for nm, g, w in (("reduced", reduced, want_red),
                     ("result", result, want_res), ("residual", res, want)):
        bad = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        assert bad == 0, f"{what}: {nm}, {bad} elements differ"


def offset_copy(t, k):
    """``t`` again, contiguous, ``k`` float32 into a fresh buffer."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
def test_combine_kernels_match_plain_versions_on_the_card(cuda_device):
    """Every edge case (both wires, W in {1, 4}, n 256 and 203: at 203
    rows 1-3 start off 16-byte alignment, the vector path's scalar heads
    and tails), acc alone off it (the scalar path), and the main path's
    shapes: BERT-base's n, VGG-16's and its two bucket n's
    (``chip_smoke.combine_inputs``)."""
    for case in CASES:
        for wire_dtype in WIRES:
            for W in (1, 4):
                for n in (256, 203):
                    cfg = OkTopkConfig(n=n, num_workers=R,
                                       wire_dtype=wire_dtype)
                    t = tensors(make_case(case, W, n), cuda_device)
                    check_on_card(n, t, cfg, f"{case} {wire_dtype} {W} {n}")
    t = tensors(make_case("random", 4, 203), cuda_device)
    cfg = OkTopkConfig(n=203, num_workers=R, wire_dtype="bfloat16")
    for k in (1, 2, 3):
        moved = dict(t, acc=offset_copy(t["acc"], k))
        check_on_card(203, moved, cfg, f"acc {4 * k} bytes off")
    smoke = chip_smoke()
    for n in (smoke.N_BERT, smoke.N_VGG16, *smoke.vgg16_bucket_sizes()):
        for wire_dtype in WIRES:
            t, cfg = smoke.combine_inputs(n, cuda_device, wire_dtype)
            check_on_card(n, t, cfg, f"n={n} {wire_dtype}")
            del t
            torch.cuda.empty_cache()
