"""Edge inputs of the compaction kernel's tiling, held on the CPU.

- The plain versions (``ops/compaction.py``) against
  ``select_by_threshold_pallas`` / ``pack_by_region_pallas`` in interpret
  mode at n = 1002: below one 1024-element block and n = 2 mod 4, with
  empty first and last regions, cap = 1 with survivors past it, an
  all-zero x and a NaN threshold. One shape: the interpreter compiles
  once per (entry point, shape, R, cap).
- The wrapper's launch geometry: ``tile_geometry`` (tiles cut on 16-byte
  boundaries of memory) and ``scratch_words``.
- ``chip_smoke.compaction_cases``, the inputs the kernel is held to on the
  card, through the plain versions against a numpy reference.

Every comparison is bit-equal: selection has no rounding.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oktopk_tpu.ops.compaction import (
    pack_by_region_pallas,
    select_by_threshold_pallas,
)

from oktopk_tpu_torch.ops import compaction

pytestmark = pytest.mark.kernels

N = 1002                     # < 1024 and n % 4 == 2
T = compaction.TILE
MIN_NORMAL = np.float32(1.17549435e-38)


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


class TestAgainstPallas:
    def test_select_cap_one_keeps_the_lowest_index(self):
        x = np.random.RandomState(0).randn(N).astype(np.float32)
        v, i, c = select_both(x, 1.0, 1)
        assert c == 1 and i[0] == np.nonzero(np.abs(x) >= 1.0)[0][0]

    @pytest.mark.parametrize("case", ["all-zero x", "NaN threshold"])
    def test_select_keeps_nothing(self, case):
        if case == "all-zero x":
            x, t = np.zeros(N, np.float32), 1.0
        else:
            x = np.random.RandomState(1).randn(N).astype(np.float32)
            t = float("nan")
        v, i, c = select_both(x, t, 1)
        assert c == 0 and i[0] == N and v[0] == 0

    @pytest.mark.parametrize("cap", [1, 64])
    @pytest.mark.parametrize("bounds", [[0, 0, 500, N, N],
                                        [0, 1, 2, N - 1, N]])
    def test_pack_empty_edge_regions(self, bounds, cap):
        x = np.random.RandomState(2).randn(N).astype(np.float32)
        v, i, c = pack_both(x, 1.0, bounds, cap)
        empty = np.diff(bounds) == 0
        assert (c[empty] == 0).all() and (i[empty] == N).all()
        assert (c[~empty] == np.minimum(cap, [
            (np.abs(x[a:b]) >= 1.0).sum()
            for a, b in zip(bounds[:-1], bounds[1:])])[~empty]).all()

    def test_pack_all_zero_x_and_nan_threshold(self):
        bounds = [0, 0, 500, N, N]
        for x, t in ((np.zeros(N, np.float32), 0.5),
                     (np.random.RandomState(3).randn(N).astype(np.float32),
                      float("nan"))):
            v, i, c = pack_both(x, t, bounds, 64)
            assert (c == 0).all() and (i == N).all() and (v == 0).all()


class TestLaunchGeometry:
    @pytest.mark.parametrize("off", [0, 1, 2, 3])
    def test_shift_follows_the_address(self, off):
        addr = 0x7F0000000200 + 4 * off
        assert compaction.tile_geometry(10, addr)[0] == off

    @pytest.mark.parametrize("n,shift,tiles", [
        (1, 0, 1), (1, 3, 1), (T, 0, 1), (T, 1, 2), (T - 3, 3, 1),
        (T - 2, 3, 2), (3 * T + 1, 0, 4), (14728266, 2, 3596)])
    def test_tiles_cover_x_once(self, n, shift, tiles):
        s, nt = compaction.tile_geometry(n, 0x1000 + 4 * shift)
        assert (s, nt) == (shift, tiles)
        # tile j holds x[j*T - shift, (j+1)*T - shift) clipped to [0, n)
        lo = np.maximum(np.arange(nt) * T - s, 0)
        hi = np.minimum(np.arange(1, nt + 1) * T - s, n)
        assert lo[0] == 0 and hi[-1] == n and (hi > lo).all()
        assert (lo[1:] == hi[:-1]).all()

    def test_scratch_words(self):
        # ticket + R+1 region offsets + one status word per tile
        assert compaction.scratch_words(3 * T + 1, 0x1008, 4) == 2 + 4 + 4
        assert compaction.scratch_words(5, 0x100C, 1) == 2 + 1 + 1


def chip_smoke():
    """``chip_smoke.py`` as a module (it lies outside the package)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numpy_pack(x, t, bounds, cap):
    """Survivors |x| >= max(t, min normal) per region, lowest index first."""
    n, R = x.size, len(bounds) - 1
    keep = np.abs(x) >= np.maximum(np.float32(t), MIN_NORMAL)
    values = np.zeros((R, cap), np.float32)
    indices = np.full((R, cap), n, np.int32)
    counts = np.zeros(R, np.int32)
    for r in range(R):
        idx = np.nonzero(keep[bounds[r]:bounds[r + 1]])[0] + bounds[r]
        counts[r] = min(idx.size, cap)
        values[r, :counts[r]] = x[idx[:cap]]
        indices[r, :counts[r]] = idx[:cap]
    return values, indices, counts


def test_card_cases_plain_versions_match_numpy():
    """The card's edge cases are well formed, and the plain versions the
    kernel is held to there agree with an independent reference."""
    cases = chip_smoke().compaction_cases()
    assert len({c["name"] for c in cases}) == len(cases) >= 14
    for case in cases:
        x, t, cap = case["x"], case["t"], case["cap"]
        xt = torch.from_numpy(x)
        want = numpy_pack(x, t, [0, x.size], cap)
        got = compaction.select_by_threshold(xt, t, cap)
        for nm, g, w in zip(("values", "indices", "count"), got, want):
            bits_equal(g.numpy(), w[0], f"{case['name']}: select {nm}")
        if case["bounds"] is not None:
            b = case["bounds"]
            got = compaction.pack_by_region(
                xt, t, torch.tensor(b, dtype=torch.int32), len(b) - 1, cap)
            for nm, g, w in zip(("values", "indices", "counts"), got,
                                numpy_pack(x, t, b, cap)):
                bits_equal(g.numpy(), w, f"{case['name']}: pack {nm}")
