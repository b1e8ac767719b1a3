"""The plain versions of the port's two Hopper kernels against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs.

- compaction (covers K2 ``_stage_kernel`` and K3 ``_repair_kernel``):
  ``ops/compaction.py`` select_by_threshold / pack_by_region against
  ``select_by_threshold_pallas`` / ``pack_by_region_pallas``;
- fused front-end (K1 ``_fused_kernel``): ``ops/fused_select.py``
  fused_select against ``fused_select_pallas`` and
  ``fused_select_reference``.

Every comparison is bit-equal (``np.array_equal`` on the int32 view of
floats): selection, packing and integer histograms have no rounding.
Inputs cover the TPU kernels' three regimes (no 1024-element block over
128 survivors; 1 to nb/8 such blocks, where K3 repairs; more, where the
1024-wide K2 restages everything), a region boundary inside an
overflowed block, the min-normal clamp and subnormals.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` and by the ``cuda``-marked test at the end.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oktopk_tpu.ops.compaction import (
    BLK,
    CAPB_FAST,
    _novf_cap,
    pack_by_region_pallas,
    select_by_threshold_pallas,
)
from oktopk_tpu.ops.fused_select import (
    fused_select_pallas,
    fused_select_reference,
)

from oktopk_tpu_torch.ops import compaction, fused_select

pytestmark = pytest.mark.kernels


def bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def select_both(x, t, cap):
    want = select_by_threshold_pallas(jnp.asarray(x), t, cap,
                                      interpret=True)
    got = compaction.select_by_threshold(torch.from_numpy(x), t, cap)
    for nm, g, w in zip(("values", "indices", "count"), got, want):
        bits_equal(g.numpy(), w, nm)
    return [g.numpy() for g in got]


def pack_both(x, t, bounds, cap):
    R = len(bounds) - 1
    want = pack_by_region_pallas(jnp.asarray(x), t,
                                 jnp.asarray(bounds, jnp.int32), R, cap,
                                 interpret=True)
    got = compaction.pack_by_region(
        torch.from_numpy(x), t, torch.tensor(bounds, dtype=torch.int32), R,
        cap)
    for nm, g, w in zip(("values", "indices", "counts"), got, want):
        bits_equal(g.numpy(), w, nm)
    return [g.numpy() for g in got]


def overflow_blocks(x, t):
    n = x.size
    pad = (-n) % BLK
    raw = (np.abs(np.pad(x, (0, pad))) >= t).reshape(-1, BLK).sum(1)
    return int((raw > CAPB_FAST).sum()), raw.size


# One shape per kernel entry point: the Pallas interpreter compiles once
# per (shape, static argument) set, and every case below reuses it.
SEL_N, SEL_CAP = 64 * BLK + 333, 8 * BLK          # 65 blocks, K3 list 9
PACK_N, PACK_R, PACK_CAP = 16 * BLK + 300, 4, 2048  # 17 blocks, K3 list 8
FUSED_N, FUSED_R, FUSED_CAP = 16 * BLK - 300, 3, 4096


class TestCompaction:
    def test_fast_regime(self):
        x = np.random.RandomState(0).randn(SEL_N).astype(np.float32)
        assert overflow_blocks(x, 2.0)[0] == 0
        select_both(x, 2.0, SEL_CAP)

    def test_bit_exact_wide_dynamic_range(self):
        rng = np.random.RandomState(1)
        x = (rng.randn(SEL_N) * 10.0 ** rng.randint(-6, 6, SEL_N)) \
            .astype(np.float32)
        select_both(x, float(np.quantile(np.abs(x), 0.97)), SEL_CAP)

    def test_lowest_index_first_overflow(self):
        x = np.random.RandomState(2).randn(SEL_N).astype(np.float32)
        v, i, c = select_both(x, 0.5, SEL_CAP)      # ~62% pass
        assert c == SEL_CAP
        np.testing.assert_array_equal(
            i, np.nonzero(np.abs(x) >= 0.5)[0][:SEL_CAP])

    def test_sentinel_contract_when_empty(self):
        x = np.zeros(SEL_N, np.float32)
        v, i, c = select_both(x, 1.0, SEL_CAP)
        assert c == 0 and (i == SEL_N).all() and (v == 0).all()

    def test_min_normal_clamp(self):
        """A zero (or negative) threshold selects exactly the nonzeros;
        subnormals fall below the clamp."""
        x = np.zeros(SEL_N, np.float32)
        x[::97] = 1.5
        x[5::211] = np.float32(1e-40)                 # subnormal
        for t in (0.0, -1.0):
            v, i, c = select_both(x, t, SEL_CAP)
            np.testing.assert_array_equal(
                i[:c], np.nonzero(np.abs(x) >= 1.17549435e-38)[0])

    def test_repair_regime(self):
        """A few blocks over the 128-wide staging (K3's regime)."""
        rng = np.random.RandomState(11)
        x = rng.randn(SEL_N).astype(np.float32) * 0.1
        for b in (3, 17, 40):
            x[b * BLK:(b + 1) * BLK] = rng.randn(BLK) * 10 + 20
        novf, nb = overflow_blocks(x, 1.0)
        assert 0 < novf <= _novf_cap(nb)
        select_both(x, 1.0, SEL_CAP)

    def test_wide_regime(self):
        """More overflowing blocks than K3's list holds (K2 at 1024)."""
        rng = np.random.RandomState(12)
        x = rng.randn(SEL_N).astype(np.float32) * 0.1
        x[:12 * BLK] = rng.randn(12 * BLK) * 0.5 + 20
        novf, nb = overflow_blocks(x, 1.0)
        assert novf > _novf_cap(nb)
        v, i, c = select_both(x, 1.0, SEL_CAP)
        assert c == SEL_CAP

    @pytest.mark.parametrize("bounds", [
        [0, 1024, 2048, 3072, PACK_N], [0, 700, 1930, 9000, PACK_N],
        [0, 64, 80, 81, PACK_N], [0, 0, 1500, PACK_N, PACK_N],
        [0, PACK_N, PACK_N, PACK_N, PACK_N]])
    def test_pack_regions(self, bounds):
        x = np.random.RandomState(5).randn(PACK_N).astype(np.float32)
        pack_both(x, 2.0, bounds, PACK_CAP)

    def test_pack_repair_with_straddling_boundary(self):
        rng = np.random.RandomState(13)
        x = rng.randn(PACK_N).astype(np.float32) * 0.1
        x[5 * BLK:6 * BLK] = rng.randn(BLK) * 10 + 20
        novf, nb = overflow_blocks(x, 1.0)
        assert 0 < novf <= _novf_cap(nb)
        pack_both(x, 1.0, [0, 5 * BLK + 700, 5 * BLK + 900, 9 * BLK,
                           PACK_N], PACK_CAP)

    def test_pack_wide_with_straddling_boundaries(self):
        rng = np.random.RandomState(14)
        x = (rng.randn(PACK_N) + 3.0).astype(np.float32)
        novf, nb = overflow_blocks(x, 0.5)
        assert novf > _novf_cap(nb)
        pack_both(x, 0.5, [0, 3 * BLK + 5, 9 * BLK + 1000, 12 * BLK + 1,
                           PACK_N], PACK_CAP)

    def test_pack_cap_overflow_per_region(self):
        x = np.random.RandomState(6).randn(PACK_N).astype(np.float32)
        v, i, c = pack_both(x, 0.3, [0, BLK, 2 * BLK, 10 * BLK, PACK_N],
                            PACK_CAP)
        assert (c[2:] == PACK_CAP).all()             # ~76% of 6-8K pass


def fused_both(g, r, t, bounds, probe_ratio=1.25):
    b = jnp.asarray(bounds, jnp.int32)
    args = (jnp.asarray(g), jnp.asarray(r), t, t * probe_ratio, b, FUSED_R,
            FUSED_CAP)
    want = fused_select_pallas(*args, interpret=True)
    ref = fused_select_reference(*args)
    got = fused_select.fused_select(
        torch.from_numpy(g), torch.from_numpy(r), t, t * probe_ratio,
        torch.tensor(bounds, dtype=torch.int32), FUSED_R, FUSED_CAP)
    names = ("acc", "values", "indices", "counts", "local_count",
             "probe_count", "hist")
    for nm, a, w, f in zip(names, got, want, ref):
        bits_equal(a.numpy(), w, nm)
        bits_equal(a.numpy(), f, nm + " (reference)")
    return dict(zip(names, (a.numpy() for a in got)))


class TestFusedSelect:
    def test_fast_regime(self):
        rng = np.random.RandomState(0)
        g = rng.randn(FUSED_N).astype(np.float32)
        r = (0.1 * rng.randn(FUSED_N)).astype(np.float32)
        assert overflow_blocks(g + r, 2.0)[0] == 0
        fused_both(g, r, 2.0, [0, FUSED_N // 3, FUSED_N // 2, FUSED_N])

    def test_repair_regime_straddling_boundary(self):
        rng = np.random.RandomState(21)
        g = (rng.randn(FUSED_N) * 0.1).astype(np.float32)
        g[:BLK] = 10.0 + rng.rand(BLK).astype(np.float32)
        g[5 * BLK:6 * BLK] = rng.randn(BLK) * 10 + 20
        r = (0.01 * rng.randn(FUSED_N)).astype(np.float32)
        novf, nb = overflow_blocks(g + r, 1.0)
        assert 0 < novf <= _novf_cap(nb)
        fused_both(g, r, 1.0, [0, 5 * BLK + 700, 11 * BLK, FUSED_N])

    def test_wide_regime(self):
        rng = np.random.RandomState(3)
        g = (rng.randn(FUSED_N) + 3.0).astype(np.float32)
        r = (0.01 * rng.randn(FUSED_N)).astype(np.float32)
        novf, nb = overflow_blocks(g + r, 0.5)
        assert novf > _novf_cap(nb)
        fused_both(g, r, 0.5, [0, 4 * BLK + 9, 4 * BLK + 10, FUSED_N])

    def test_probe_unclamped_stage_clamped(self):
        g = np.zeros(FUSED_N, np.float32)
        g[:10] = 3.0
        out = fused_both(g, np.zeros(FUSED_N, np.float32), 0.0,
                         [0, 5, 4000, FUSED_N])
        assert out["local_count"] == 10 and out["probe_count"] == FUSED_N

    def test_wide_dynamic_range_hist(self):
        rng = np.random.RandomState(1)
        g = (rng.randn(FUSED_N) * 10.0 ** rng.randint(-30, 20, FUSED_N)) \
            .astype(np.float32)
        g[::11] = np.exp2(rng.randint(-40, 20, len(g[::11]))) \
            .astype(np.float32)
        r = (1e-3 * rng.randn(FUSED_N)).astype(np.float32)
        t = float(np.quantile(np.abs(g + r), 0.97))
        fused_both(g, r, t, [0, 1000, 9000, FUSED_N])

    def test_subnormal_acc_kept_and_binned(self):
        """H4: acc = grad + residual keeps subnormal sums (IEEE, as the
        CUDA build without -ftz does), bins them at 1, and the clamped
        selection leaves them out. Held against numpy: XLA's CPU backend
        flushes subnormal arithmetic results to zero, so the JAX
        reference agrees here only where acc is normal or zero."""
        rng = np.random.RandomState(4)
        n = FUSED_N
        g = rng.randn(n).astype(np.float32)
        g[3::13] = np.float32(3e-41) * rng.randint(1, 100, len(g[3::13]))
        r = np.zeros(n, np.float32)
        r[7::17] = np.float32(1e-42)
        st = fused_select.fused_select_stage(torch.from_numpy(g),
                                             torch.from_numpy(r), 0.5,
                                             0.0)
        acc = g + r                                   # numpy: IEEE
        bits_equal(st.acc.numpy(), acc, "acc")
        sub = (acc != 0) & (np.abs(acc) < 1.17549435e-38)
        assert sub.sum() > 500
        mag = acc.view(np.int32) & 0x7FFFFFFF
        bins = np.maximum(mag >> 23, 1)[mag != 0]
        np.testing.assert_array_equal(st.hist.numpy(),
                                      np.bincount(bins, minlength=256))
        assert int(st.local_count) == int((np.abs(acc) >= 0.5).sum())
        assert int(st.probe_count) == n
        ref = fused_select_reference(jnp.asarray(g), jnp.asarray(r), 0.5,
                                     0.0, jnp.asarray([0, n], jnp.int32),
                                     1, FUSED_CAP)
        normal = ~sub
        np.testing.assert_array_equal(st.acc.numpy()[normal],
                                      np.asarray(ref[0])[normal])
        assert (np.asarray(ref[0])[sub] == 0).all()   # XLA CPU: flushed


class TestDeviceContract:
    def test_wrappers_raise_on_a_device_they_cannot_serve(self):
        x = torch.empty(4096, device="meta")
        with pytest.raises(ValueError):
            compaction.select_by_threshold(x, 1.0, 64)
        with pytest.raises(ValueError):
            compaction.pack_by_region(
                x, 1.0, torch.tensor([0, 4096], dtype=torch.int32), 1, 64)
        with pytest.raises(ValueError):
            fused_select.fused_select_stage(x, x, 1.0, 1.25)

    def test_cpu_tensor_takes_the_plain_version(self):
        before = (compaction.LAUNCHES, fused_select.LAUNCHES)
        x = torch.randn(3 * BLK)
        fused_select.fused_select(x, x, 1.0, 1.25,
                                  torch.tensor([0, 3 * BLK],
                                               dtype=torch.int32), 1, 64)
        assert (compaction.LAUNCHES, fused_select.LAUNCHES) == before


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda_device):
    """On a GPU: both kernels against their plain versions on the card,
    in the three regimes, bit-equal."""
    rng = np.random.RandomState(0)
    n = 64 * BLK + 333
    x = rng.randn(n).astype(np.float32) * 0.1
    for b in (3, 17, 40):
        x[b * BLK:(b + 1) * BLK] = rng.randn(BLK) * 10 + 20
    wide = (rng.randn(n) + 3.0).astype(np.float32)
    res = (0.01 * rng.randn(n)).astype(np.float32)
    bnd = [0, 3 * BLK + 500, 17 * BLK + 7, 40 * BLK + 1000, n]
    for xs, t in ((x, 2.0), (x, 1.0), (wide, 0.5)):
        xc = torch.from_numpy(xs).to(cuda_device)
        rc = torch.from_numpy(res).to(cuda_device)
        bc = torch.tensor(bnd, dtype=torch.int32, device=cuda_device)
        got = fused_select.fused_select(xc, rc, t, 1.25 * t, bc, 4, 8 * BLK)
        want = fused_select.fused_select(xc.cpu(), rc.cpu(), t, 1.25 * t,
                                         bc.cpu(), 4, 8 * BLK)
        for g, w in zip(got, want):
            bits_equal(g.cpu().numpy(), w.numpy(), "fused")
        got = compaction.select_by_threshold(xc, t, 16 * BLK)
        want = compaction.select_by_threshold(xc.cpu(), t, 16 * BLK)
        for g, w in zip(got, want):
            bits_equal(g.cpu().numpy(), w.numpy(), "select")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")
