"""The port's baseline allreduces (topkA, topkA2, topkAopt, gtopk,
gaussiank, topkSA, gaussiankSA) on the stacked comm against the JAX
package's ``build_allreduce_step`` on the 8-device CPU mesh, and the ops
they add: the tie rule of ``exact_topk``, ``gaussian_threshold`` and the
kernel form of ``select_nonzero``.

Each port step starts from the JAX state of the same step and sees the
same gradients (one step deep, as in ``test_torch_oktopk.py``). Held:

- bit-equal: the reduced result, the residual, the step, volume and
  wire-byte counters and the realised counts, under both wire formats;
- within ``ULPS`` ulps: the carried local threshold. topkAopt and topkSA
  use the count bisection, whose log2/exp2 differ in the last bit (H1);
  the Gaussian fit's float32 mean, std and ``erf_inv`` differ in the last
  bits between XLA and PyTorch (``scripts/port_parity_probe.py`` gives the
  largest distance over many rows), and its bisection carries that into
  the threshold.

The Gaussian family's results are bit-equal only where both thresholds
select the same set; each comparison asserts that premise (no |acc|
between the two thresholds) before it compares.

The JAX side runs its portable path (``use_pallas=False`` on a CPU mesh);
the port follows the kernel contract, which differs from it only for
thresholds below the smallest normal f32 and for subnormal values (H4,
H5): these inputs keep every threshold and every reduced value normal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.collectives.api import batched_init_state as jax_init
from oktopk_tpu.collectives.api import build_allreduce_step as jax_build
from oktopk_tpu.collectives.registry import ALGORITHMS as JAX_ALGORITHMS
from oktopk_tpu.config import OkTopkConfig as JaxConfig

from oktopk_tpu_torch.collectives import api, registry
from oktopk_tpu_torch.collectives.state import SparseState
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.ops import compaction
from oktopk_tpu_torch.ops.gaussian import gaussian_threshold
from oktopk_tpu_torch.ops.topk import exact_topk

ULPS = 8
EXACT = ("step", "boundaries", "residual", "volume_elems", "last_volume",
         "wire_bytes", "last_wire_bytes", "last_local_count",
         "last_global_count", "global_threshold", "drift", "last_exact_lt")
SPARSE = ("topkA", "topkA2", "topkAopt", "gtopk", "gaussiank", "topkSA",
          "gaussiankSA")
GAUSSIAN = ("gaussiank", "gaussiankSA")

# cadence 2: steps 0 and 2 recompute the local threshold, step 1 predicts
BASE = dict(n=1 << 14, num_workers=8, density=0.02, warmup_steps=0,
            local_recompute_every=2)


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def none_between(x, t1, t2):
    """No |x| in [min(t1, t2), max(t1, t2)): both thresholds select the
    same elements."""
    lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
    a = np.abs(x)
    return not ((a >= lo) & (a < hi)).any()


def make_grads(P, n, steps, seed):
    rng = np.random.RandomState(seed)
    base = rng.randn(P, n).astype(np.float32)
    return [base + 0.3 * rng.randn(P, n).astype(np.float32)
            for _ in range(steps)]


def run_jax(mesh, name, cfg_kw, grads, warmup=False):
    cfg = JaxConfig(**cfg_kw)
    # the JAX warmup cond around topkAopt/topkSA fails shard_map's
    # varying-axes check (its branches differ in vma); the check is a type
    # check only and changes no value
    step = jax_build(name, cfg, mesh, warmup=warmup, check_vma=False)
    state = jax_init(cfg)
    states, outs = [jax.tree.map(np.asarray, state)], []
    for g in grads:
        out, state = step(jnp.asarray(g), state)
        outs.append(np.asarray(out))
        states.append(jax.tree.map(np.asarray, state))
    return outs, states


def compare_stepwise(mesh, name, cfg_kw, grads, warmup=False):
    """Each port step from the JAX state of that step; returns the port's
    states."""
    outs, states = run_jax(mesh, name, cfg_kw, grads, warmup)
    cfg = OkTopkConfig(**cfg_kw)
    step = api.build_allreduce_step(name, cfg, warmup=warmup)
    got_states = []
    for i, g in enumerate(grads):
        st = SparseState.from_numpy(states[i], "cpu")
        out, st2 = step(torch.from_numpy(g), st)
        got, want = st2.to_numpy(), states[i + 1]
        if name in GAUSSIAN:
            acc = g + states[i].residual
            for w in range(cfg.num_workers):
                assert none_between(acc[w], got["local_threshold"][w],
                                    want.local_threshold[w]), (i, w)
        np.testing.assert_array_equal(out.numpy(), outs[i],
                                      err_msg=f"result, step {i}")
        for f in EXACT:
            np.testing.assert_array_equal(got[f], getattr(want, f),
                                          err_msg=f"{f}, step {i}")
        u = ulps(got["local_threshold"], want.local_threshold)
        assert u <= ULPS, f"local_threshold, step {i}: {u} ulps"
        got_states.append(st2)
    return got_states


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SPARSE)
def test_baseline_matches_jax_stepwise(mesh8, name, wire):
    """Recompute and predicted steps (cadence 2 over 3 steps), both wire
    formats; gtopk's three butterfly rounds at P = 8."""
    kw = dict(BASE, wire_dtype=wire)
    compare_stepwise(mesh8, name, kw, make_grads(8, BASE["n"], 3, seed=4))


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_topksa_dense_fallback_matches_jax(mesh8, wire):
    """Density 1: every element is selected, the reduced result is dense,
    the psum fallback is taken (volume 2n) and its gather is not rounded,
    so the owner's rounding term is off (JAX tests/test_collectives.py
    ``TestTopkSA``)."""
    n = 1 << 12
    kw = dict(BASE, n=n, density=1.0, wire_dtype=wire)
    states = compare_stepwise(mesh8, "topkSA", kw,
                              make_grads(8, n, 1, seed=5))
    assert float(states[0].last_volume[0]) >= 2.0 * n


def test_dense_warmup_then_baselines(mesh8):
    """The registry's warmup wrapping: one dense step, then the first
    sparse step recomputes its threshold."""
    kw = dict(BASE, warmup_steps=1, wire_dtype="bfloat16")
    grads = make_grads(8, BASE["n"], 2, seed=6)
    for name in ("topkAopt", "topkSA"):
        compare_stepwise(mesh8, name, kw, grads, warmup=True)


def test_gtopk_needs_power_of_two_workers():
    cfg = OkTopkConfig(n=64, num_workers=6, density=0.1, warmup_steps=0)
    step = api.build_allreduce_step("gtopk", cfg, warmup=False)
    with pytest.raises(ValueError, match="power-of-two"):
        step(torch.zeros(6, 64), api.batched_init_state(cfg, "cpu"))
    with pytest.raises(ValueError):
        StackedComm(6).ppermute_pair(torch.zeros(6, 2), 4)


def test_ppermute_pair_matches_jax(mesh8):
    from jax.sharding import PartitionSpec as Ps
    from oktopk_tpu.comm import compat
    from oktopk_tpu.comm.primitives import ppermute_pair

    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    comm = StackedComm(8)
    assert comm.axis_size() == 8
    for d in (1, 2, 4):
        f = jax.jit(compat.shard_map(
            lambda a: ppermute_pair(a[0], "data", d)[None], mesh=mesh8,
            in_specs=Ps("data"), out_specs=Ps("data")))
        np.testing.assert_array_equal(
            comm.ppermute_pair(torch.from_numpy(x), d).numpy(),
            np.asarray(f(jnp.asarray(x))))


def test_registry_names_and_aliases():
    """Every JAX registry name, ``hierarchical`` included, whose dense
    warmup goes on its outer level (``test_torch_hierarchical.py``)."""
    assert set(registry.list_algorithms()) == set(JAX_ALGORITHMS)
    assert registry.ALGORITHMS["gaussiankconcat"] is \
        registry.ALGORITHMS["gaussiank"]
    assert registry.ALGORITHMS["topkDSA"] is registry.ALGORITHMS["topkSA"]
    assert registry.get_algorithm("hierarchical") is \
        registry.ALGORITHMS["hierarchical"]
    with pytest.raises(ValueError):
        registry.get_algorithm("nope")
    assert registry.get_algorithm("dense") is registry.ALGORITHMS["dense"]
    assert registry.get_algorithm("topkA").__name__ == "warmup(topk_a)"
    assert registry.get_algorithm("topkA", warmup=False) is \
        registry.ALGORITHMS["topkA"]


def test_eps_vs_dense_and_timing(mesh8):
    from oktopk_tpu.collectives.api import eps_vs_dense as jax_eps
    rng = np.random.RandomState(8)
    d = rng.randn(3000).astype(np.float32)
    s = (d * (rng.rand(3000) < 0.1)).astype(np.float32)
    got = float(api.eps_vs_dense(torch.from_numpy(d), torch.from_numpy(s)))
    # a ratio of two float32 norms summed in different orders
    np.testing.assert_allclose(got, float(jax_eps(jnp.asarray(d),
                                                  jnp.asarray(s))),
                               rtol=1e-6)
    cfg = OkTopkConfig(n=512, num_workers=8, density=0.05, warmup_steps=0)
    step = api.build_allreduce_step("topkA", cfg, warmup=False)
    g = torch.from_numpy(make_grads(8, 512, 1, seed=9)[0])
    times, st = api.time_allreduce_step(step, g,
                                        api.batched_init_state(cfg, "cpu"),
                                        iters=2)
    assert len(times) == 2 and all(t > 0 for t in times)
    assert st.host_step == 3


@pytest.mark.parametrize("seed", range(3))
def test_exact_topk_planted_ties(seed):
    """Magnitudes drawn from a handful of values, signs mixed, zeros
    included: ``lax.top_k`` breaks every tie by lower index; so must the
    port (values, indices and their order), per row of a batch too."""
    from oktopk_tpu.ops.topk import exact_topk as jax_topk
    rng = np.random.RandomState(seed)
    vals = np.float32([0.0, 0.5, 1.0, 2.0, 3.0])
    x = (rng.choice(vals, size=(3, 2000))
         * rng.choice([-1.0, 1.0], size=(3, 2000))).astype(np.float32)
    for k in (1, 7, 400, 1500, 2000):
        gv, gi = exact_topk(torch.from_numpy(x), k)
        for r in range(3):
            wv, wi = jax_topk(jnp.asarray(x[r]), k)
            np.testing.assert_array_equal(gi[r].numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gv[r].numpy().view(np.int32),
                                          np.asarray(wv).view(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_gaussian_threshold_within_ulps(seed):
    """Per-row thresholds against ``ops/gaussian.py`` on scaled, shifted
    normal rows; where no |x| lies between the two, the selections agree
    (asserted, not assumed)."""
    from oktopk_tpu.ops import gaussian as jax_gaussian
    jax_gauss = jax.jit(jax_gaussian.gaussian_threshold, static_argnums=1)
    rng = np.random.RandomState(100 + seed)
    n = 1 << 14
    x = (rng.randn(4, n) * 10.0 ** rng.uniform(-3, 3, (4, 1))
         + rng.randn(4, 1)).astype(np.float32)
    for k in (16, 327, 4000):
        got = gaussian_threshold(torch.from_numpy(x), k).numpy()
        for r in range(4):
            want = np.float32(jax_gauss(jnp.asarray(x[r]), k))
            assert ulps(got[r], want) <= ULPS, (k, r)
            assert none_between(x[r], got[r], want), (k, r)
            assert (np.abs(x[r]) >= got[r]).sum() == \
                (np.abs(x[r]) >= want).sum()


def test_select_nonzero_kernel_form():
    """The compaction kernel at threshold 0 (its plain version on the
    CPU) against JAX's ``select_nonzero(use_pallas=True)`` form, the
    Pallas kernel at threshold 0 in interpret mode: the nonzeros, with
    subnormals left out by the min-normal clamp. Without subnormals it
    equals the portable ``x != 0`` form the JAX CPU mesh runs."""
    from oktopk_tpu.ops.compaction import select_by_threshold_pallas
    from oktopk_tpu.ops.select import select_nonzero as jax_nonzero
    rng = np.random.RandomState(10)
    n = 5000
    x = np.zeros(n, np.float32)
    x[rng.choice(n, 400, replace=False)] = rng.randn(400)
    x[::613] = np.float32(1e-40)
    subnormal = np.nonzero(x == np.float32(1e-40))[0]
    # cap 100 of ~400 nonzeros: lowest-index-first retention past cap,
    # and the subnormal at index 0 must not take a slot
    got = compaction.select_nonzero(torch.from_numpy(x), 100)
    want = select_by_threshold_pallas(jnp.asarray(x), 0.0, 100,
                                      interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.isin(subnormal, got[1].numpy()).any()
    xn = np.where(np.abs(x) < 1e-38, 0, x).astype(np.float32)
    for g, w in zip(compaction.select_nonzero(torch.from_numpy(xn), 1000),
                    jax_nonzero(jnp.asarray(xn), 1000)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
