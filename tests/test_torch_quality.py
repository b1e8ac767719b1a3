"""The port's signal-fidelity tap (``obs/quality.py``,
``obs/metrics_buffer.py``, ``collectives/api.py::
build_quality_allreduce_step``) and its wire-byte budgets
(``obs/volume.py``) against the JAX package's, on the same numpy inputs.

Held:

- equal: the winner signature, ``eff_density``, ``step`` and
  ``skipped``, the ring's cursor and slots, the quality event, and every
  budget (pure Python, the same floats);
- within ``RTOL`` = 1e-5: ``comp_err``, ``res_norm``, ``res_growth``,
  ``thr_drift`` and ``churn``. Each is a float32 sum over n elements (or
  a ratio of such sums), which XLA and PyTorch add in different orders;
  1e-5 is a few float32 roundings of an n = 2^14 sum, far below the 5e-3
  of JAX's own dense-vs-sparse oracle (``tests/test_quality.py``).

Each tapped port step starts from the JAX state and ring of the same
step (one step deep, H1), flat (``oktopk``, ``topkA`` on the 8-device
mesh) and hierarchical (2 pods x 4: the ``dense`` and ``oktopk`` outers).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.collectives import api as jax_api
from oktopk_tpu.collectives.hierarchical import \
    make_hierarchical_config as jax_make
from oktopk_tpu.collectives.registry import ALGORITHMS as JAX_ALGORITHMS
from oktopk_tpu.comm.mesh import hierarchical_mesh
from oktopk_tpu.config import OkTopkConfig as JaxConfig
from oktopk_tpu.obs import metrics_buffer as jax_mb
from oktopk_tpu.obs import quality as jax_q
from oktopk_tpu.obs import volume as jax_volume

from oktopk_tpu_torch.collectives import api
from oktopk_tpu_torch.collectives.hierarchical import \
    make_hierarchical_config
from oktopk_tpu_torch.collectives.state import SparseState
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.obs import metrics_buffer as mb
from oktopk_tpu_torch.obs import quality, volume

RTOL = 1e-5
COL = {c: i for i, c in enumerate(mb.COLUMNS)}
EQUAL_COLS = ("step", "eff_density", "skipped")
CLOSE_COLS = ("comp_err", "res_norm", "res_growth", "thr_drift", "churn")
N = 1 << 14
FLAT = dict(n=N, num_workers=8, density=0.01, warmup_steps=0,
            local_recompute_every=1, global_recompute_every=2)
Q = quality.QualityConfig(every=4, sig_bins=256)


def jax_buffer(P):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (P,) + x.shape),
                        jax_mb.init_buffer(Q.every, Q.sig_bins))


def grads(P, n, steps, seed):
    rng = np.random.RandomState(seed)
    base = rng.randn(P, n).astype(np.float32)
    return [base + 0.3 * rng.randn(P, n).astype(np.float32)
            for _ in range(steps)]


# ---- ring and tap primitives -------------------------------------------

def test_columns_and_config_match_jax():
    assert mb.COLUMNS == jax_mb.COLUMNS and mb.NUM_COLS == jax_mb.NUM_COLS
    assert dataclasses.asdict(quality.QualityConfig()) == \
        dataclasses.asdict(jax_q.QualityConfig())
    for kw in (dict(every=0), dict(sig_bins=100), dict(sig_bins=1)):
        with pytest.raises(ValueError) as port_err:
            quality.QualityConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            jax_q.QualityConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("n,bins", [(1000, 2), (N, 256), (N + 3, 512),
                                    (1 << 20, 1024)])
def test_winner_signature_matches_jax(n, bins):
    """The uint32 hash in int64 with wrap-around (the product passes 2^32
    from index 2 on): equal bins, an empty selection all zero."""
    rng = np.random.RandomState(n % 97)
    x = rng.randn(3, n).astype(np.float32)
    x[np.abs(x) < 1.5] = 0.0
    x[1] = 0.0                                        # an empty selection
    got = quality.winner_signature(torch.from_numpy(x), bins).numpy()
    for w in range(3):
        want = np.asarray(jax_q.winner_signature(jnp.asarray(x[w]), bins))
        np.testing.assert_array_equal(got[w], want)
    assert got[1].sum() == 0.0


def _row(step, **kw):
    r = np.zeros(mb.NUM_COLS, np.float32)
    r[COL["step"]] = step
    for k, v in kw.items():
        r[COL[k]] = v
    return r


def test_push_row_wraps_and_skips_as_jax():
    """Seven pushes into a ring of 3, two of them skipped: the ring, the
    monotonic cursor and the frozen baselines equal JAX's after every
    push, and ``rows_since`` drains the same rows."""
    W, cap, bins = 2, 3, 8
    buf = mb.init_buffer(cap, bins, W, "cpu")
    jbuf = jax_mb.init_buffer(cap, bins)
    drained = 0
    for s in range(7):
        skipped = s in (2, 5)
        row = _row(s + 1, comp_err=0.1 * (s + 1), res_norm=float(s))
        sig = np.full(bins, float(s % 2), np.float32)
        rn = np.float32(s + 0.5)
        buf = mb.push_row(
            buf, torch.from_numpy(np.stack([row] * W)),
            torch.from_numpy(np.stack([sig] * W)), torch.full((W,), rn),
            torch.full((W,), skipped))
        jbuf = jax_mb.push_row(jbuf, jnp.asarray(row), jnp.asarray(sig),
                               jnp.asarray(rn), jnp.asarray(skipped))
        for w in range(W):
            for f in mb.FIELDS:
                np.testing.assert_array_equal(
                    getattr(buf, f)[w].numpy(), np.asarray(getattr(jbuf, f)),
                    err_msg=f"{f} after push {s}")
        if s in (1, 6):
            cur = int(buf.cursor[0])
            got = mb.rows_since(buf.ring.numpy(), cur, drained)
            want = jax_mb.rows_since(np.asarray(jbuf.ring), cur, drained)
            np.testing.assert_array_equal(got, want)
            drained = cur
    assert int(buf.cursor[0]) == 7
    assert float(buf.prev_res_norm[0]) == 6.5        # push 6 committed
    assert mb.rows_since(buf.ring.numpy(), 7, 7).shape == (0, mb.NUM_COLS)
    back = mb.QualityBuffer.from_numpy(
        jax.tree.map(lambda x: np.broadcast_to(x, (W,) + x.shape), jbuf),
        "cpu")
    for f in mb.FIELDS:
        assert torch.equal(getattr(back, f), getattr(buf, f)), f


def test_quality_event_matches_jax():
    rows = np.array([_row(3, comp_err=0.25, churn=math.nan, skipped=1.0),
                     _row(4, res_norm=math.inf, eff_density=0.01)],
                    np.float64)
    got = quality.quality_event(4, 1, "oktopk", rows)
    assert got == jax_q.quality_event(4, 1, "oktopk", rows)
    assert got["churn"][0] is None and got["res_norm"][1] is None
    assert got["skipped"] == [1, 0] and got["steps"] == [3, 4]


# ---- the tapped allreduce step -----------------------------------------

def check_rows(got_buf, want_buf, what):
    g, w = got_buf.to_numpy(), jax.tree.map(np.asarray, want_buf)
    np.testing.assert_array_equal(g["cursor"], w.cursor, err_msg=what)
    np.testing.assert_array_equal(g["prev_sig"], w.prev_sig, err_msg=what)
    cur = int(g["cursor"][0])
    for r in range(g["ring"].shape[0]):
        got = mb.rows_since(g["ring"][r], cur, cur - 1)[-1]
        want = jax_mb.rows_since(w.ring[r], cur, cur - 1)[-1]
        for c in EQUAL_COLS:
            assert got[COL[c]] == want[COL[c]], (what, r, c)
        for c in CLOSE_COLS:
            np.testing.assert_allclose(got[COL[c]], want[COL[c]], rtol=RTOL,
                                       atol=0, err_msg=f"{what} {r} {c}")
    np.testing.assert_allclose(g["prev_res_norm"], w.prev_res_norm,
                               rtol=RTOL, atol=0, err_msg=what)
    return g


def run_tapped(name, jcfg, pcfg, mesh, gs, what):
    """JAX's tapped steps; then each port step from the JAX state and ring
    of that step. Returns the port's last ring arrays."""
    P = jcfg.num_workers
    jstep = jax_api.build_quality_allreduce_step(name, jcfg, mesh, Q,
                                                 warmup=False)
    st, qb = jax_api.batched_init_state(jcfg), jax_buffer(P)
    pstep = api.build_quality_allreduce_step(name, pcfg, quality=Q,
                                             warmup=False)
    last = None
    for i, g in enumerate(gs):
        pst = SparseState.from_numpy(jax.tree.map(np.asarray, st), "cpu")
        pqb = mb.QualityBuffer.from_numpy(jax.tree.map(np.asarray, qb),
                                          "cpu")
        out, st, qb = jstep(jnp.asarray(g), st, qb)
        pout, _, pqb = pstep(torch.from_numpy(g), pst, pqb)
        np.testing.assert_array_equal(pout.numpy(), np.asarray(out),
                                      err_msg=f"{what} result, step {i}")
        last = check_rows(pqb, qb, f"{what} step {i}")
    return last


@pytest.mark.parametrize("name", ["oktopk", "topkA"])
def test_flat_tap_matches_jax(mesh8, name):
    """Three steps: an exact recompute, a predicted step, an exact one
    (oktopk); churn and res_growth against a committed baseline from the
    second step on."""
    run_tapped(name, JaxConfig(**FLAT), OkTopkConfig(**FLAT), mesh8,
               grads(8, N, 3, seed=7), name)


@pytest.fixture(scope="module")
def hmesh(devices):
    return hierarchical_mesh(2, 4, devices=devices[:8])


@pytest.mark.parametrize("outer", ["dense", "oktopk"])
def test_hierarchical_tap_matches_jax(hmesh, outer):
    """2 pods x 4: the dense reference is the pod mean plus the pod-level
    residual, averaged across pods. A dense outer is lossless, so its
    ``comp_err`` is at most 1e-10 and it delivers the full-world mean."""
    jh = jax_make(JaxConfig(**FLAT), num_pods=2, outer=outer)
    ph = make_hierarchical_config(OkTopkConfig(**FLAT), num_pods=2,
                                  outer=outer)
    gs = grads(8, N, 2, seed=9)
    ring = run_tapped("hierarchical", jh, ph, hmesh, gs, outer)
    row = mb.rows_since(ring["ring"], int(ring["cursor"][0]), 0)[-1]
    assert np.isfinite(row).all()
    if outer == "dense":
        assert row[COL["comp_err"]] <= 1e-10
        assert row[COL["eff_density"]] > 0.99
        step = api.build_allreduce_step("hierarchical", ph, warmup=False)
        out, _ = step(torch.from_numpy(gs[0]),
                      api.batched_init_state(ph, "cpu"))
        np.testing.assert_allclose(out[0].numpy(), gs[0].mean(0), atol=1e-5)


# ---- budgets -----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n=1 << 20, num_workers=8, density=0.01),
    dict(n=14728266, num_workers=4, density=0.02, wire_dtype="float32")])
def test_flat_budgets_match_jax(kw):
    names = sorted(set(JAX_ALGORITHMS) - {"hierarchical"})
    got_cfg, want_cfg = OkTopkConfig(**kw), JaxConfig(**kw)
    for name in names:
        for fn in ("budget_bytes", "capacity_bytes"):
            assert getattr(volume, fn)(name, got_cfg) == \
                getattr(jax_volume, fn)(name, want_cfg), (name, fn)
        assert volume.conformance_ratio(name, got_cfg, 12345.0) == \
            jax_volume.conformance_ratio(name, want_cfg, 12345.0)
        assert volume.volume_report(name, got_cfg, 4321.5, bucket=2,
                                    step=7, steps=6) == \
            jax_volume.volume_report(name, want_cfg, 4321.5, bucket=2,
                                     step=7, steps=6)
    for mod, cfg in ((volume, got_cfg), (jax_volume, want_cfg)):
        with pytest.raises(ValueError, match="no wire-byte budget"):
            mod.budget_bytes("nope", cfg)
