"""The port's plain ops against the JAX package's, on the same numpy
inputs: residual transforms, selection and packing, scatter, exact top-k,
the exponent histogram and its threshold read, the count bisection, the
config copy and ``scheduled_k``.

Everything is compared bit-for-bit (``np.array_equal``, int32 views of
floats) except the bisection threshold: its bracket arithmetic uses
log2/exp2, whose last bit differs between XLA and PyTorch (H1). The
bracket lives in log2 space, so one ulp of an exponent e becomes about
0.7*|e| ulps of the threshold 2^e, and the bracket edges carry a few such
roundings (|e| < 16 for these inputs): the threshold is held to
``BISECT_ULPS`` ulps, and the elements it selects must be equal.

Subnormals: XLA's CPU backend treats subnormal operands as zero and
flushes subnormal results (a compare, an add, exp2(-126)); PyTorch and the
CUDA build keep IEEE subnormals. Where the two differ, the port is held to
the IEEE result and the test says so.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oktopk_tpu import config as jcfg
from oktopk_tpu.ops import hist_threshold as jh
from oktopk_tpu.ops import residual as jr
from oktopk_tpu.ops import select as js
from oktopk_tpu.ops import topk as jt
from oktopk_tpu.ops.pallas_topk import k2threshold_bisect as j_bisect

from oktopk_tpu_torch import config as tcfg
from oktopk_tpu_torch.ops import hist_threshold as th
from oktopk_tpu_torch.ops import residual as tr
from oktopk_tpu_torch.ops import select as ts
from oktopk_tpu_torch.ops import topk as tt

BISECT_ULPS = 32


def eq(got, want, what=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if g.dtype == np.float32:
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=what)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


@pytest.fixture
def x():
    rng = np.random.RandomState(0)
    return (rng.randn(5000) * 10.0 ** rng.randint(-4, 4, 5000)) \
        .astype(np.float32)


class TestResidual:
    def test_transforms(self, x):
        rng = np.random.RandomState(1)
        r = rng.randn(x.size).astype(np.float32)
        m = rng.rand(x.size) < 0.3
        eq(tr.add_residual(T(x), T(r)), jr.add_residual(J(x), J(r)))
        eq(tr.update_residual_at_winners(T(x), T(m)),
           jr.update_residual_at_winners(J(x), J(m)))
        eq(tr.update_residual_at_selection(T(x), T(m)),
           jr.update_residual_at_selection(J(x), J(m)))


class TestSelect:
    @pytest.mark.parametrize("cap", [1, 64, 5000, 6000])
    def test_select_mask_and_threshold(self, x, cap):
        t = float(np.quantile(np.abs(x), 0.9))
        m = np.abs(x) >= t
        for got, want in ((ts.select_mask(T(x), T(m), cap),
                           js.select_mask(J(x), J(m), cap)),
                          (ts.select_by_threshold(T(x), t, cap),
                           js.select_by_threshold(J(x), t, cap))):
            for nm, g, w in zip(("values", "indices", "count"), got, want):
                eq(g, w, nm)

    def test_sentinel_and_lowest_index_first(self, x):
        v, i, c = ts.select_by_threshold(T(x), 0.0, 100)   # all pass
        assert int(c) == 100
        np.testing.assert_array_equal(i.numpy(), np.arange(100))
        v, i, c = ts.select_by_threshold(T(x), 1e30, 100)  # none pass
        assert int(c) == 0 and (i.numpy() == x.size).all()
        assert (v.numpy() == 0).all()

    def test_select_nonzero(self):
        x = np.zeros(300, np.float32)
        x[::7] = 2.0
        x[5::9] = -3e-30
        for nm, g, w in zip(("values", "indices", "count"),
                            ts.select_nonzero(T(x), 128),
                            js.select_nonzero(J(x), 128)):
            eq(g, w, nm)

    def test_select_nonzero_keeps_subnormals(self):
        """IEEE: a subnormal is nonzero (XLA's CPU backend compares it as
        zero and drops it)."""
        x = np.zeros(300, np.float32)
        x[::7] = 2.0
        x[3::11] = np.float32(1e-40)
        v, i, c = ts.select_nonzero(T(x), 128)
        want = np.nonzero(x)[0]
        assert int(c) == len(want)
        np.testing.assert_array_equal(i.numpy()[:len(want)], want)
        assert int(js.select_nonzero(J(x), 128)[2]) == (x >= 1.0).sum()

    def test_count_and_region_mask(self, x):
        t = float(np.quantile(np.abs(x), 0.7))
        eq(ts.count_by_threshold(T(x), t).to(torch.int32),
           js.count_by_threshold(J(x), t))
        b = np.array([0, 100, 2500, 2500, 5000], np.int32)
        for r in range(4):
            eq(ts.region_mask(x.size, T(b), r),
               js.region_mask(x.size, J(b), r), f"region {r}")

    @pytest.mark.parametrize("bounds", [[0, 5000], [0, 1000, 2000, 5000],
                                        [0, 0, 4999, 5000, 5000]])
    @pytest.mark.parametrize("cap", [16, 400])
    def test_pack_by_region(self, x, bounds, cap):
        m = np.abs(x) >= float(np.quantile(np.abs(x), 0.8))
        R = len(bounds) - 1
        b = np.array(bounds, np.int32)
        for nm, g, w in zip(("values", "indices", "counts"),
                            ts.pack_by_region(T(x), T(m), T(b), R, cap),
                            js.pack_by_region(J(x), J(m), J(b), R, cap)):
            eq(g, w, nm)

    def test_scatter_sparse_rank_order_and_sentinel(self):
        """[P, cap] rows with overlapping indices (the phase-(a) combine)
        and sentinel slots; summed row by row in rank order."""
        rng = np.random.RandomState(3)
        P, cap, n = 8, 300, 1000
        idx = np.stack([np.sort(rng.choice(n + 1, cap, replace=False))
                        for _ in range(P)]).astype(np.int32)
        vals = (rng.randn(P, cap) * 10.0 ** rng.randint(-5, 5, (P, cap))) \
            .astype(np.float32)
        eq(ts.scatter_sparse(n, T(vals), T(idx)),
           js.scatter_sparse(n, J(vals), J(idx)))
        base = rng.randn(n).astype(np.float32)
        eq(ts.scatter_sparse(n, T(vals[0]), T(idx[0]), base=T(base)),
           js.scatter_sparse(n, J(vals[0]), J(idx[0]), base=J(base)))


class TestTopk:
    @pytest.mark.parametrize("k", [1, 50, 4999])
    def test_exact_topk_and_k2threshold(self, x, k):
        gv, gi = tt.exact_topk(T(x), k)
        wv, wi = jt.exact_topk(J(x), k)
        eq(gv, wv)
        eq(gi.to(torch.int32), wi)
        eq(tt.k2threshold(T(np.abs(x)), k), jt.k2threshold(J(np.abs(x)), k))
        eq(tt.k2threshold_method(T(np.abs(x)), k, "sort"),
           jt.k2threshold_method(J(np.abs(x)), k, "sort"))

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("k", [1, 37, 655])
    def test_bisect_within_ulps_and_same_selection(self, seed, k):
        rng = np.random.RandomState(seed)
        a = np.abs(rng.randn(1 << 14) * 10.0 ** rng.randint(-3, 3, 1 << 14)) \
            .astype(np.float32)
        got = tt.k2threshold_bisect(T(a), k).numpy()
        want = np.asarray(j_bisect(J(a), k))
        d = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
        assert d <= BISECT_ULPS, d
        np.testing.assert_array_equal(a >= got, a >= want)
        assert (a >= got).sum() >= k

    def test_bisect_edge_cases(self):
        z = np.zeros(100, np.float32)
        eq(tt.k2threshold_bisect(T(z), 5), j_bisect(J(z), 5))
        # fewer than k live elements: the bracket floor, clamped at 2^-126
        # (XLA's CPU exp2 flushes exp2(-126) to 0 — the absorbing zero the
        # clamp exists to prevent; the port returns the documented floor)
        tiny = np.full(100, 1e-30, np.float32)
        got = tt.k2threshold_bisect(T(tiny), 500).numpy()
        assert got == np.float32(2.0 ** -126)
        assert np.asarray(j_bisect(J(tiny), 500)) == 0.0


class TestHist:
    def test_bins_and_hist_with_subnormals(self):
        """H4: subnormals go to bin 1, zeros are excluded, inf/nan go to
        bin 255 — bit extraction on both sides."""
        rng = np.random.RandomState(4)
        x = (rng.randn(4000) * 10.0 ** rng.randint(-40, 38, 4000)) \
            .astype(np.float32)
        x[::9] = 0.0
        x[1::13] = np.float32(3e-41) * rng.randint(1, 99, len(x[1::13]))
        x[5] = np.inf
        x[6] = -np.nan
        x[7:40] = np.exp2(np.arange(-126, -93)).astype(np.float32)
        eq(th.log2_bins(T(x)), jh.log2_bins(J(x)))
        h = th.log2_hist(T(x))
        eq(h, jh.log2_hist(J(x)))
        assert int(h[1]) >= len(x[1::13])

    @pytest.mark.parametrize("k", [0, 1, 10, 999, 3000, 10 ** 6])
    def test_hist_to_threshold(self, k):
        rng = np.random.RandomState(5)
        x = np.abs(rng.randn(3000) * 10.0 ** rng.randint(-20, 20, 3000)) \
            .astype(np.float32)
        h = np.asarray(jh.log2_hist(J(x)))
        eq(th.hist_to_threshold(T(h), k), jh.hist_to_threshold(J(h), k))
        eq(th.k2threshold_hist(T(x), k), jh.k2threshold_hist(J(x), k))
        eq(tt.k2threshold_method(T(x), k, "hist"),
           jt.k2threshold_method(J(x), k, "hist"))

    def test_empty_histogram_gives_zero(self):
        z = np.zeros(256, np.int32)
        eq(th.hist_to_threshold(T(z), 3), jh.hist_to_threshold(J(z), 3))


class TestConfig:
    def test_fields_and_defaults_match(self):
        """The port's copy of OkTopkConfig has every field of the JAX one,
        with the same default."""
        jf = {f.name: f.default for f in dataclasses.fields(jcfg.OkTopkConfig)}
        tf = {f.name: f.default for f in dataclasses.fields(tcfg.OkTopkConfig)}
        assert jf == tf

    @pytest.mark.parametrize("kw", [
        dict(n=14728266, num_workers=4, density=0.02),
        dict(n=1 << 15, num_workers=8, density=0.01),
        dict(n=100, num_workers=3, density=0.5, wire_dtype="float32")])
    def test_properties(self, kw):
        a, b = jcfg.OkTopkConfig(**kw), tcfg.OkTopkConfig(**kw)
        for p in ("k", "k_region", "cap_pair", "cap_gather", "cap_exact",
                  "cap_local", "wire_value_bytes", "wire_pair_bytes"):
            assert getattr(a, p) == getattr(b, p), p

    @pytest.mark.parametrize("kw", [
        dict(wire_dtype="float16"), dict(threshold_method="topk"),
        dict(local_k_target=0.5), dict(density_schedule=((5, 0.01),)),
        dict(density_schedule=((0, 0.01), (10, 0.05))),
        dict(density_schedule=((0, 0.01),), threshold_method="sort")])
    def test_validation_matches(self, kw):
        with pytest.raises(ValueError):
            jcfg.OkTopkConfig(**kw)
        with pytest.raises(ValueError):
            tcfg.OkTopkConfig(**kw)

    def test_scheduled_and_target_k(self):
        from oktopk_tpu.collectives.oktopk import _target_k as j_target
        sched = ((0, 0.005), (3, 0.01), (7, 0.02))
        a = jcfg.OkTopkConfig(n=32768, density=0.02, density_schedule=sched)
        b = tcfg.OkTopkConfig(n=32768, density=0.02, density_schedule=sched)
        for step in range(10):
            kj = jcfg.scheduled_k(a, jnp.int32(step))
            kt = tcfg.scheduled_k(b, step)
            assert int(kj) == kt
            for f in (0.9, 0.85, 0.7):
                assert int(j_target(kj, a.n, f)) == tcfg.target_k(b, kt, f)
        c = tcfg.OkTopkConfig(n=32768, density=0.02)
        assert tcfg.scheduled_k(c, 5) == jcfg.scheduled_k(
            jcfg.OkTopkConfig(n=32768, density=0.02), 5)
        for k in (1, 655, 32768):
            assert tcfg.target_k(c, k, 0.9) == j_target(k, c.n, 0.9)
