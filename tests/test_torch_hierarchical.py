"""The port's two-level hierarchical allreduce (dense inside a pod, a
registry algorithm across pods) on the stacked two-level comm, against
the JAX package's ``build_allreduce_step("hierarchical", ...)`` on the
8-device CPU mesh as 2 pods x 4 (``tests/test_hierarchical.py``'s
sizes), and its fabric presets, configuration and per-level budgets.

Held:

- bit-equal to JAX over three chained steps for the ``dense`` and
  ``topkA`` outers: results, residuals, counters and the four per-level
  wire fields (the pod mean adds the members in index order and divides
  by the pod size, as ``lax.pmean`` on the CPU mesh does);
- ``oktopk`` one step deep from the JAX state of each step (H1, as in
  ``test_torch_oktopk.py``): the same fields bit-equal, thresholds within
  ``ULPS`` ulps;
- inside the port, the composition identity bit-exact over 8 steps:
  ``hierarchical`` over 2 x 4 equals the flat outer over
  ``StackedComm(2)`` fed the pod means;
- the outer warmup against JAX built with ``check_vma=False``: its warmup
  ``lax.cond`` fails shard_map's varying-axes check, a type check that
  changes no value (ROADMAP Queue 3).

The JAX side runs its portable path (``use_pallas=False`` on a CPU mesh);
the port follows the kernel contract, which differs from it only for
thresholds below the smallest normal f32: these inputs keep every
threshold normal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.collectives.api import batched_init_state as jax_init
from oktopk_tpu.collectives.api import build_allreduce_step as jax_build
from oktopk_tpu.collectives.hierarchical import \
    HierarchicalConfig as JaxHConfig
from oktopk_tpu.collectives.hierarchical import \
    make_hierarchical_config as jax_make
from oktopk_tpu.comm import fabric as jax_fabric
from oktopk_tpu.comm.mesh import hierarchical_mesh
from oktopk_tpu.config import OkTopkConfig as JaxConfig
from oktopk_tpu.obs import volume as jax_volume

from oktopk_tpu_torch.collectives import api
from oktopk_tpu_torch.collectives.hierarchical import (
    HierarchicalConfig,
    make_hierarchical_config,
)
from oktopk_tpu_torch.collectives.registry import get_algorithm
from oktopk_tpu_torch.collectives.state import TENSOR_FIELDS, SparseState
from oktopk_tpu_torch.comm import StackedComm, fabric, hierarchical_comm
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.obs import volume

N = 512
PODS, POD_SIZE = 2, 4
P = PODS * POD_SIZE
ULPS = 8
EXACT = ("step", "boundaries", "residual", "volume_elems", "last_volume",
         "wire_bytes", "last_wire_bytes", "wire_bytes_intra",
         "last_wire_bytes_intra", "wire_bytes_inter",
         "last_wire_bytes_inter", "last_local_count", "last_global_count")
THRESHOLDS = ("local_threshold", "global_threshold", "drift",
              "last_exact_lt")
# cadence 2: the oktopk steps alternate exact recompute and prediction
FLAT = dict(n=N, num_workers=P, density=0.05, warmup_steps=0,
            local_recompute_every=2, global_recompute_every=2)


@pytest.fixture(scope="module")
def hmesh(devices):
    return hierarchical_mesh(PODS, POD_SIZE, devices=devices[:P])


def grads(steps, seed):
    rng = np.random.RandomState(seed)
    base = rng.randn(P, N).astype(np.float32)
    return [base + 0.3 * rng.randn(P, N).astype(np.float32)
            for _ in range(steps)]


def pod_means(g):
    """[PODS, N]: each pod's members added in index order in float32, then
    divided by the pod size."""
    v = g.reshape(PODS, POD_SIZE, N)
    s = v[:, 0].copy()
    for m in range(1, POD_SIZE):
        s = s + v[:, m]
    return s / np.float32(POD_SIZE)


def ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def run_jax(hmesh, outer, flat_kw, gs, warmup=False, check_vma=True):
    h = jax_make(JaxConfig(**flat_kw), num_pods=PODS, outer=outer)
    step = jax_build("hierarchical", h, hmesh, warmup=warmup,
                     check_vma=check_vma)
    state = jax_init(h)
    states, outs = [jax.tree.map(np.asarray, state)], []
    for g in gs:
        out, state = step(jnp.asarray(g), state)
        outs.append(np.asarray(out))
        states.append(jax.tree.map(np.asarray, state))
    return outs, states


def port_cfg(outer, flat_kw):
    return make_hierarchical_config(OkTopkConfig(**flat_kw), num_pods=PODS,
                                    outer=outer)


# ---- fabric ------------------------------------------------------------

def test_fabric_presets_match_jax():
    assert fabric.alpha_beta_table() == jax_fabric.alpha_beta_table()
    assert fabric.PLAN_SELECT_GAMMA == jax_fabric.PLAN_SELECT_GAMMA
    for name, want in jax_fabric.FABRIC_PRESETS.items():
        got = fabric.get_fabric(name)
        assert (got.name, got.alpha_s, got.gbps) == (want.name, want.alpha_s,
                                                     want.gbps)
        for b in (2, 4):
            assert got.beta_elem(b) == want.beta_elem(b)
        assert dataclasses.asdict(got.coefficients()) == \
            dataclasses.asdict(want.coefficients())
    with pytest.raises(ValueError) as port_err:
        fabric.get_fabric("infiniband")
    with pytest.raises(ValueError) as jax_err:
        jax_fabric.get_fabric("infiniband")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("spec", ["dcn", "gbe", "ici", "preset", "pair"])
def test_two_level_fabric_matches_jax(spec):
    def resolve(mod):
        if spec == "preset":
            return mod.resolve_two_level(mod.FABRIC_PRESETS["dcn"])
        if spec == "pair":
            tw = mod.two_level("gbe", intra="dcn")
            assert mod.resolve_two_level(tw) is tw
            return tw
        return mod.resolve_two_level(spec)

    got, want = resolve(fabric), resolve(jax_fabric)
    assert got.name == want.name
    for lvl in ("intra", "inter"):
        g, w = getattr(got, lvl), getattr(want, lvl)
        assert (g.name, g.alpha_s, g.gbps) == (w.name, w.alpha_s, w.gbps)


# ---- configuration -----------------------------------------------------

def _fields(h):
    top = {f.name: getattr(h, f.name) for f in dataclasses.fields(h)
           if f.name != "outer_cfg"}
    outer = {f.name: getattr(h.outer_cfg, f.name)
             for f in dataclasses.fields(OkTopkConfig)}
    return top, outer, (h.n, h.num_workers, h.density, h.level_plan())


@pytest.mark.parametrize("kw", [
    dict(outer="oktopk"), dict(outer="dense"), dict(outer="topkA"),
    dict(outer="oktopk", density_split=0.5), dict(pod_size=4),
    dict(outer="gtopk", inter_axis="x", intra_axis="y")])
def test_config_matches_jax(kw):
    flat = dict(FLAT, density=0.02)
    got = make_hierarchical_config(OkTopkConfig(**flat), num_pods=PODS, **kw)
    want = jax_make(JaxConfig(**flat), num_pods=PODS, **kw)
    assert _fields(got) == _fields(want)
    assert got.replace(outer_warmup=False).outer_warmup is False


@pytest.mark.parametrize("case", [
    dict(num_pods=3), dict(num_pods=2, inner="oktopk"),
    dict(num_pods=2, inter_axis="x", intra_axis="x"),
    dict(num_pods=2, pod_size=3), dict(num_pods=2, density_split=0.0),
    dict(direct=True)])
def test_config_errors_match_jax(case):
    def build(mk, hc, cfg_cls):
        flat = cfg_cls(**dict(FLAT, density=0.05))
        if case.get("direct"):
            return hc(outer_cfg=flat, num_pods=2, pod_size=4)
        return mk(flat, **case)

    with pytest.raises(ValueError) as port_err:
        build(make_hierarchical_config, HierarchicalConfig, OkTopkConfig)
    with pytest.raises(ValueError) as jax_err:
        build(jax_make, JaxHConfig, JaxConfig)
    assert str(port_err.value) == str(jax_err.value)


def test_build_step_rejects_flat_config_mismatched_comm_and_wrong_name():
    flat = OkTopkConfig(**FLAT)
    h = make_hierarchical_config(flat, num_pods=PODS)
    with pytest.raises(TypeError, match="HierarchicalConfig"):
        api.build_allreduce_step("hierarchical", flat)
    with pytest.raises(ValueError, match="name='hierarchical'"):
        api.build_allreduce_step("oktopk", h)
    with pytest.raises(ValueError, match="'pod' .* size 4, config wants 2"):
        api.build_allreduce_step("hierarchical", h, hierarchical_comm(4, 2))
    with pytest.raises(ValueError, match="size None"):
        api.build_allreduce_step("hierarchical", h, StackedComm(P))
    # the default comm is the config's two-level shape
    step = api.build_allreduce_step("hierarchical", h, warmup=False)
    st = api.batched_init_state(h, "cpu")
    assert st.residual.shape == (P, N)
    assert st.boundaries.shape == (P, PODS + 1)
    out, st = step(torch.zeros(P, N), st)
    assert out.shape == (P, N) and st.host_step == 1


def test_registry_warmup_stays_on_the_outer_level():
    from oktopk_tpu_torch.collectives import hierarchical as mod
    assert get_algorithm("hierarchical") is mod.hierarchical
    assert get_algorithm("hierarchical", warmup=False) is mod.hierarchical


# ---- the stacked two-level comm ----------------------------------------

def test_pod_mean_adds_in_member_order_then_divides():
    """1e8 + 1 rounds to 1e8 in float32: in member order the pod's sum is
    ((1e8 + 1) - 1e8) + 1 = 1; another order gives 0 or 2. The sum is
    divided by the pod size, not multiplied by its inverse."""
    comm = hierarchical_comm(2, 4)
    x = torch.tensor([[1e8], [1.0], [-1e8], [1.0],
                      [1.0], [2.0], [4.0], [3.0]])
    got = comm.pod_mean(x)
    want = torch.tensor([0.25] * 4 + [2.5] * 4).unsqueeze(1)
    assert torch.equal(got, want)
    y = torch.full((8, 1), 0.1)
    s = ((y[0] + y[1]) + y[2]) + y[3]
    assert torch.equal(comm.pod_mean(y)[5], s / 4)
    assert comm.size == comm.local_workers == 8
    assert (comm.intra.size, comm.inter.size) == (4, 2)
    assert torch.equal(comm.leaders(torch.arange(8)), torch.tensor([0, 4]))
    spread = comm.spread(torch.tensor([[7], [9]]))
    assert spread.reshape(-1).tolist() == [7] * 4 + [9] * 4
    spread[0, 0] = 1                     # each row its own copy
    assert spread[1, 0] == 7


# ---- against JAX -------------------------------------------------------

@pytest.mark.parametrize("outer", ["dense", "topkA", "gaussiank"])
def test_matches_jax_chained(hmesh, outer):
    """Three chained steps (no state taken from JAX): topkA's exact top-k
    and gaussiank's fit at the outer's P = 2, on the bf16 wire."""
    kw = dict(FLAT, wire_dtype="bfloat16")
    gs = grads(3, seed=3)
    outs, states = run_jax(hmesh, outer, kw, gs)
    step = api.build_allreduce_step("hierarchical", port_cfg(outer, kw),
                                    warmup=False)
    st = SparseState.from_numpy(states[0], "cpu")
    for i, g in enumerate(gs):
        out, st = step(torch.from_numpy(g), st)
        np.testing.assert_array_equal(out.numpy(), outs[i],
                                      err_msg=f"result, step {i}")
        got = st.to_numpy()
        for f in EXACT:
            np.testing.assert_array_equal(got[f], getattr(states[i + 1], f),
                                          err_msg=f"{f}, step {i}")
        assert ulps(got["local_threshold"],
                    states[i + 1].local_threshold) <= ULPS


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_oktopk_outer_matches_jax_stepwise(hmesh, wire):
    kw = dict(FLAT, wire_dtype=wire, repartition_every=3)
    gs = grads(3, seed=4)
    outs, states = run_jax(hmesh, "oktopk", kw, gs)
    step = api.build_allreduce_step("hierarchical", port_cfg("oktopk", kw),
                                    warmup=False)
    for i, g in enumerate(gs):
        out, st = step(torch.from_numpy(g),
                       SparseState.from_numpy(states[i], "cpu"))
        np.testing.assert_array_equal(out.numpy(), outs[i],
                                      err_msg=f"result, step {i}")
        got = st.to_numpy()
        for f in EXACT:
            np.testing.assert_array_equal(got[f], getattr(states[i + 1], f),
                                          err_msg=f"{f}, step {i}")
        for f in THRESHOLDS:
            u = ulps(got[f], getattr(states[i + 1], f))
            assert u <= ULPS, f"{f}, step {i}: {u} ulps"


def test_outer_warmup_matches_jax(hmesh):
    """``warmup=True``, ``warmup_steps=1``: the first step is the dense
    outer, so the whole composition is the full-world dense mean."""
    kw = dict(FLAT, warmup_steps=1)
    g = grads(1, seed=5)[0]
    outs, states = run_jax(hmesh, "oktopk", kw, [g], warmup=True,
                           check_vma=False)
    step = api.build_allreduce_step("hierarchical", port_cfg("oktopk", kw),
                                    warmup=True)
    out, st = step(torch.from_numpy(g), api.batched_init_state(
        port_cfg("oktopk", kw), "cpu"))
    np.testing.assert_array_equal(out.numpy(), outs[0])
    got = st.to_numpy()
    for f in EXACT + THRESHOLDS:
        np.testing.assert_array_equal(got[f], getattr(states[1], f),
                                      err_msg=f)
    np.testing.assert_allclose(out[0].numpy(), g.mean(0), atol=1e-5)
    assert int(st.step[0]) == 1 and st.host_step == 1


# ---- the composition identity inside the port --------------------------

@pytest.mark.parametrize("outer", ["dense", "oktopk", "topkA"])
def test_composition_identity(outer):
    """hierarchical over 2 x 4 == the flat outer over ``StackedComm(2)``
    fed the pod means, at every one of 8 steps: results, every state
    field but the per-level ones, and the inter-level wire equal to the
    flat run's wire."""
    kw = dict(FLAT, density=0.02, repartition_every=3)
    h = port_cfg(outer, kw)
    hstep = api.build_allreduce_step("hierarchical", h, warmup=False)
    fstep = api.build_allreduce_step(outer, h.outer_cfg, StackedComm(PODS),
                                     warmup=False)
    hs = api.batched_init_state(h, "cpu")
    fs = api.batched_init_state(h.outer_cfg, "cpu")
    intra = 2.0 * N * (POD_SIZE - 1) / POD_SIZE
    for i, g in enumerate(grads(8, seed=11)):
        hout, hs = hstep(torch.from_numpy(g), hs)
        fout, fs = fstep(torch.from_numpy(pod_means(g)), fs)
        for p in range(PODS):
            rows = slice(p * POD_SIZE, (p + 1) * POD_SIZE)
            assert torch.equal(hout[rows], fout[p].expand(POD_SIZE, N)), i
            for f in TENSOR_FIELDS:
                hv, fv = getattr(hs, f)[rows], getattr(fs, f)[p]
                if f in ("volume_elems", "last_volume"):
                    fv = fv + (intra * (i + 1) if f == "volume_elems"
                               else intra)
                elif f in ("wire_bytes", "last_wire_bytes"):
                    fv = fv + 4.0 * intra * (i + 1 if f == "wire_bytes"
                                             else 1)
                elif f == "last_wire_bytes_inter":
                    fv = fs.last_wire_bytes[p]
                elif f == "wire_bytes_inter":
                    fv = fs.wire_bytes[p]
                elif f in ("last_wire_bytes_intra", "wire_bytes_intra"):
                    fv = torch.tensor(4.0 * intra * (
                        i + 1 if f == "wire_bytes_intra" else 1))
                assert torch.equal(hv, fv.expand_as(hv)), (i, f)
        assert hs.host_step == fs.host_step == i + 1


# ---- per-level budgets -------------------------------------------------

@pytest.mark.parametrize("outer", ["dense", "oktopk", "topkA"])
def test_hierarchical_budgets_match_jax(outer):
    for kw in (dict(FLAT), dict(FLAT, n=1 << 20, density=0.01,
                                wire_dtype="float32")):
        got = port_cfg(outer, kw)
        want = jax_make(JaxConfig(**kw), num_pods=PODS, outer=outer)
        assert volume.hierarchical_budget_bytes(got) == \
            jax_volume.hierarchical_budget_bytes(want)
        for fn in ("budget_bytes", "capacity_bytes"):
            assert getattr(volume, fn)("hierarchical", got) == \
                getattr(jax_volume, fn)("hierarchical", want)
        assert volume.hierarchical_volume_report(
            got, 1536.0, 1234.5, bucket=1, step=9, steps=8) == \
            jax_volume.hierarchical_volume_report(
                want, 1536.0, 1234.5, bucket=1, step=9, steps=8)
    with pytest.raises(TypeError, match="HierarchicalConfig"):
        volume.budget_bytes("hierarchical", OkTopkConfig(**FLAT))


def test_per_level_conformance_nine_steps():
    """Nine oktopk-outer steps (``test_hierarchical.py:309-350``): the
    steady steps' per-level means within their budgets on every level;
    the every-4th exact recompute, which draws from the larger
    ``cap_exact`` pool, is left out of the steady mean."""
    kw = dict(FLAT, local_recompute_every=1, global_recompute_every=4)
    h = port_cfg("oktopk", kw)
    step = api.build_allreduce_step("hierarchical", h, warmup=False)
    st = api.batched_init_state(h, "cpu")
    rng = np.random.RandomState(13)
    intra, inter = [], []
    for i in range(9):
        _, st = step(torch.from_numpy(rng.randn(P, N).astype(np.float32)),
                     st)
        if i % h.outer_cfg.global_recompute_every != 0:
            intra.append(float(st.last_wire_bytes_intra[0]))
            inter.append(float(st.last_wire_bytes_inter[0]))
    budgets = volume.hierarchical_budget_bytes(h)
    assert budgets["intra"] == 2.0 * N * (POD_SIZE - 1) / POD_SIZE * 4.0
    assert budgets["inter"] == volume.budget_bytes("oktopk", h.outer_cfg)
    reports = volume.hierarchical_volume_report(
        h, sum(intra) / len(intra), sum(inter) / len(inter), step=9,
        steps=9)
    assert [r["level"] for r in reports] == ["intra", "inter", "total"]
    for r in reports:
        assert 0.0 < r["conformance_ratio"] <= 1.0, r
