"""The port's oktopk on the stacked comm against the JAX oktopk on the
8-device CPU mesh (``collectives/api.py::build_allreduce_step``).

Each port step starts from the JAX state of the same step and sees the
same gradients, so the comparison is one step deep: threshold arithmetic
(log/pow/log2/exp2) differs in the last bit between XLA and PyTorch, and
a multi-step trajectory would carry that forward (the H1 contract):

- bit-equal: the reduced result, the residual, boundaries, step, volume
  and wire-byte counters and the realised counts;
- within ``ULPS`` ulps: local/global threshold, drift, last exact local
  threshold (two log/pow evaluations and a multiply feed each, each off
  by at most an ulp or two).

The JAX side runs its portable path (``use_pallas=False`` on a CPU mesh);
the port follows the kernel contract, which differs from it only for
thresholds below the smallest normal f32 — these inputs keep every
threshold normal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.collectives.api import batched_init_state, \
    build_allreduce_step
from oktopk_tpu.config import OkTopkConfig as JaxConfig

from oktopk_tpu_torch.collectives.registry import get_algorithm
from oktopk_tpu_torch.collectives.state import SparseState, init_state
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig

ULPS = 8
EXACT = ("step", "boundaries", "residual", "volume_elems", "last_volume",
         "wire_bytes", "last_wire_bytes", "last_local_count",
         "last_global_count")
THRESHOLDS = ("local_threshold", "global_threshold", "drift",
              "last_exact_lt")


def assert_ulps(a, b, ulps, what):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b)), what
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    assert d.max() <= ulps, f"{what}: {d.max()} ulps apart"


def run_jax(mesh, cfg_kw, grads, warmup):
    cfg = JaxConfig(**cfg_kw)
    step = build_allreduce_step("oktopk", cfg, mesh, warmup=warmup)
    state = batched_init_state(cfg)
    states, outs = [jax.tree.map(np.asarray, state)], []
    for g in grads:
        out, state = step(jnp.asarray(g), state)
        outs.append(np.asarray(out))
        states.append(jax.tree.map(np.asarray, state))
    return outs, states


def compare_stepwise(mesh, cfg_kw, grads, warmup=False):
    P = cfg_kw["num_workers"]
    outs, states = run_jax(mesh, cfg_kw, grads, warmup)
    cfg = OkTopkConfig(**cfg_kw)
    comm = StackedComm(P)
    algo = get_algorithm("oktopk", warmup=warmup)
    for i, g in enumerate(grads):
        st = SparseState.from_numpy(states[i], "cpu")
        out, st2 = algo(torch.from_numpy(g), st, cfg, comm)
        np.testing.assert_array_equal(out.numpy(), outs[i],
                                      err_msg=f"result, step {i}")
        got, want = st2.to_numpy(), states[i + 1]
        for f in EXACT:
            np.testing.assert_array_equal(got[f], getattr(want, f),
                                          err_msg=f"{f}, step {i}")
        for f in THRESHOLDS:
            assert_ulps(got[f], getattr(want, f), ULPS, f"{f}, step {i}")
        assert st2.host_step == i + 1


def make_grads(P, n, steps, seed):
    rng = np.random.RandomState(seed)
    base = rng.randn(P, n).astype(np.float32)
    return [base + 0.3 * rng.randn(P, n).astype(np.float32)
            for _ in range(steps)]


# Exact global recomputes land on exact local ones: a predicted local
# threshold under this fast-growing residual can select so few elements
# that the global candidate pool holds fewer than k nonzeros; the global
# threshold is then 0, where the reference's portable select takes zeros
# and the kernel contract does not (the min-normal clamp, H5).
BASE = dict(n=1 << 15, num_workers=8, density=0.02, warmup_steps=0,
            local_recompute_every=2, global_recompute_every=2,
            repartition_every=3)


@pytest.mark.parametrize("method", ["sort", "hist", "bisect"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_oktopk_matches_jax_stepwise(mesh8, method, wire):
    """Recompute, predicted and repartition steps (cadences 2/2/3 over 6
    steps), each threshold method, both wire formats."""
    kw = dict(BASE, threshold_method=method, wire_dtype=wire)
    compare_stepwise(mesh8, kw, make_grads(8, BASE["n"], 6, seed=1))


def test_unfused_rung_matches_jax(mesh8):
    """``fuse_select=False``: separate passes + the compaction kernel's
    own count pass; same results as the fused rung and the reference."""
    kw = dict(BASE, threshold_method="hist", wire_dtype="bfloat16",
              fuse_select=False)
    compare_stepwise(mesh8, kw, make_grads(8, BASE["n"], 5, seed=2))


def test_dense_warmup_then_oktopk(mesh8):
    """``with_warmup``: two dense steps (pmean in rank order, bit-equal)
    on the host step counter, then the first sparse step recomputes."""
    kw = dict(BASE, warmup_steps=2, threshold_method="sort",
              wire_dtype="float32")
    compare_stepwise(mesh8, kw, make_grads(8, BASE["n"], 4, seed=3),
                     warmup=True)


def test_repartition_psum_in_rank_order():
    """H6: the repartition averages P float32 cut positions whose sum can
    pass 2^24 at VGG-16 size; the stacked psum adds them in rank order,
    which is what the JAX CPU mesh does (sequential, not pairwise)."""
    P = 8
    rng = np.random.RandomState(0)
    x = (2.0 ** 24 + rng.randint(0, 2 ** 22, size=(P, 3))).astype(np.float32)
    got = StackedComm(P).psum(torch.from_numpy(x)).numpy()
    seq = x[0].copy()
    for p in range(1, P):
        seq = seq + x[p]
    np.testing.assert_array_equal(got[0], seq)
    np.testing.assert_array_equal(got[P - 1], seq)
    pairwise = ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5])
                                                  + (x[6] + x[7]))
    assert not np.array_equal(seq, pairwise)   # the order does matter here


def test_stacked_comm_matches_jax_collectives(mesh8):
    """psum/pmean/all_gather/all_to_all of the stacked comm against the
    JAX collectives on the CPU mesh, bit-for-bit."""
    from jax import lax
    from jax.sharding import PartitionSpec as Ps
    from oktopk_tpu.comm import compat

    P = 8
    rng = np.random.RandomState(7)
    x = (rng.randn(P, P, 5) * 10.0 ** rng.randint(-6, 6, (P, P, 5))) \
        .astype(np.float32)

    def body(a):
        a = a[0]
        return (lax.psum(a, "data")[None], lax.pmean(a, "data")[None],
                lax.all_gather(a, "data")[None],
                lax.all_to_all(a, "data", 0, 0)[None])

    f = jax.jit(compat.shard_map(body, mesh=mesh8, in_specs=Ps("data"),
                                 out_specs=Ps("data")))
    want = [np.asarray(o) for o in f(jnp.asarray(x))]
    comm = StackedComm(P)
    t = torch.from_numpy(x)
    got = [comm.psum(t), comm.pmean(t), comm.all_gather(t),
           comm.all_to_all(t)]
    for nm, g, w in zip(("psum", "pmean", "all_gather", "all_to_all"),
                        got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=nm)
    np.testing.assert_array_equal(comm.rank("cpu").numpy(), np.arange(P))


@pytest.mark.parametrize("shape,dtype", [
    ((4, 1001), torch.int32), ((3, 7), torch.int64), ((1, 50), torch.int32),
    ((2, 3, 40), torch.int64), ((513,), torch.int32)])
def test_cumsum_rows_equals_the_row_wise_scan(shape, dtype):
    """One scan of the flattened mask less each row's start is bit-equal
    to the row-wise cumsum (``_repartition`` and ``exact_topk`` use it)."""
    from oktopk_tpu_torch.ops.topk import cumsum_rows
    m = torch.from_numpy(np.random.RandomState(3).rand(*shape) < 0.4)
    got = cumsum_rows(m, dtype)
    want = torch.cumsum(m, -1, dtype=dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,density", [(4099, 0.02), (1 << 14, 0.3),
                                       (1000, 0.0)])
def test_repartition_matches_jax(mesh8, n, density):
    """The port's ``_repartition`` (flattened scan, rank-order psum)
    against the JAX one under shard_map on the 8-device mesh: the same
    boundaries, bit for bit, with skewed rows and a row with no hit."""
    from jax.sharding import PartitionSpec as Ps
    from oktopk_tpu.collectives.oktopk import _repartition as jax_rep
    from oktopk_tpu.comm import compat
    from oktopk_tpu_torch.collectives.oktopk import _repartition

    P = 8
    rng = np.random.RandomState(5)
    a = np.abs(rng.randn(P, n)).astype(np.float32)
    a[:, : n // 5] *= 3.0                     # hits crowd the first fifth
    lt = np.array([np.sort(r)[-max(1, int(density * n))] for r in a],
                  np.float32)
    lt[3] = np.inf                            # a worker with no hit
    cfg = JaxConfig(n=n, num_workers=P)

    def body(x, t):
        return jax_rep(x[0], t[0], cfg, "data")[None]

    f = jax.jit(compat.shard_map(body, mesh=mesh8, in_specs=(Ps("data"),
                                                             Ps("data")),
                                 out_specs=Ps("data"), check_vma=False))
    want = np.asarray(f(jnp.asarray(a), jnp.asarray(lt)))
    got = _repartition(torch.from_numpy(a), torch.from_numpy(lt),
                       OkTopkConfig(n=n, num_workers=P), StackedComm(P))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_state_matches_jax():
    from oktopk_tpu.collectives.state import init_state as jax_init
    for n, P in ((1000, 8), (1 << 15, 4), (7, 3)):
        want = jax.tree.map(np.asarray, jax_init(JaxConfig(n=n,
                                                           num_workers=P)))
        got = init_state(OkTopkConfig(n=n, num_workers=P), 2, "cpu")
        for f, a in got.to_numpy().items():
            w = getattr(want, f)
            np.testing.assert_array_equal(a[0], w, err_msg=f)
            assert a[0].dtype == w.dtype, f


@pytest.mark.slow
def test_volume_probe_matches_reference():
    """The bench volume probe (bench.py:58-105: n=2^20, P=8, d=0.01,
    local_recompute_every=1, global_recompute_every=4, 13 steps, the
    predicted steps averaged) run free on the port. The JAX probe's
    steady-state mean is 50,094.7 elements = 150,284 wire bytes per
    worker per step (BENCH_r05.json). The port reproduces both to the
    record's precision: 13 steps are not deep enough for the thresholds'
    last-bit differences (H1) to move a selection here."""
    P, n = 8, 1 << 20
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.01, warmup_steps=0,
                       local_recompute_every=1, global_recompute_every=4)
    comm = StackedComm(P)
    algo = get_algorithm("oktopk", warmup=False)
    state = init_state(cfg, P, "cpu")
    rng = np.random.RandomState(0)
    base = rng.randn(P, n).astype(np.float32)
    vols, wires = [], []
    for i in range(13):
        grads = base + 0.3 * rng.randn(P, n).astype(np.float32)
        _, state = algo(torch.from_numpy(grads), state, cfg, comm)
        if i % 4 != 0:
            vols.append(float(state.last_volume[0]))
            wires.append(float(state.last_wire_bytes[0]))
    assert round(sum(vols) / len(vols), 1) == 50094.7, vols
    assert sum(wires) / len(wires) == 150284.0, wires
