"""The port across processes: ``ProcessGroupComm`` over four gloo
processes on the CPU, held to ``StackedComm`` and to the JAX package.

The reference tested its multi-node behaviour with local processes over
gloo (``tests/conftest.py:3-6``); so do these tests. One spawn of four
processes (``torch_dist_child.checks_worker``) runs every check of the
module, and each test reads what its part wrote:

- each comm verb on seeded inputs, bit-equal to the stacked comm's row
  for that rank, including a float ``psum`` whose value depends on the
  order of its adds (H6);
- every registered compressor (dense, oktopk in each threshold method,
  fused and unfused, on both wires, with a dense warmup; each baseline on
  both wires; topkSA on its dense fallback on one step and not on the
  next) at n = 2^15, three steps: results and every state field bit-equal
  to the stacked comm's;
- oktopk one step deep from the JAX state of each step, against JAX's
  ``build_allreduce_step`` on the 4-device CPU mesh: results, residuals
  and counters bit-equal, thresholds within ``ULPS`` ulps (H1, as in
  ``test_torch_oktopk.py``);
- three narrow-VGG Trainer steps: bit-equal to the stacked Trainer on
  every rank, and within ``test_torch_vgg.py``'s tolerances of the JAX
  Trainer on the 4-device mesh; then a checkpoint (every rank's sparse
  state gathered to rank 0) whose state is the stacked Trainer's file
  bit for bit, restored on four ranks, each taking its own row;
- a narrow-VGG run that rank 1 alone asks to stop: every rank stops at
  that step and its epilogue returns 3, and rank 0's parked state is
  the stacked Trainer's parked file bit for bit;
- three guarded narrow-VGG steps with a ``nan_grad`` on rank 2 at step
  1: every rank skips that step alone, bit-equal to the stacked Trainer;
- a guarded narrow-VGG run whose consecutive skips restore the
  checkpoint every rank registered, then find the next restore
  unavailable after a write failure that rank 0 alone saw: bit-equal to
  the stacked Trainer on every rank;
- two ``bert_tiny`` Trainer steps with dropout 0.1, each rank deriving
  its own worker's keys: bit-equal to the stacked Trainer on every rank,
  and the keys and masks JAX's for that worker (the JAX Trainer's key
  chain in ``jax.random``, flax's site key and ``bernoulli``);
- one resnet20 oktopk step (BatchNorm statistics rank 0's everywhere):
  bit-equal to the stacked Trainer on every rank;
- the autotuner on the narrow VGG over two buckets with real probes and
  trials: every rank fits the same coefficients and takes the same plan
  (the medians agreed over the ranks), and a regression that rank 2
  alone sees re-tunes every rank, with the same ``retune`` event;
- the two-level ``hierarchical`` step as 2 pods x 2 over
  ``dist.new_group`` groups, with the ``dense``, ``oktopk`` and ``topkA``
  outers: results and every state field bit-equal on every rank to the
  two-level stacked comm's row;
- the pipeline (``parallel/``) on a data x pipe grid of 2 x 2 over
  ``dist.new_group`` groups: the ring hop, the broadcast from the last
  stage and ``to_rows``, values and gradients, and two sparse (oktopk)
  pipeline steps of ``bert_tiny`` with dropout, bit-equal on every rank
  to the stacked grid's row.

Three more spawns run ``main_trainer`` and ``main_bert`` as two ranks,
and ``main_bert --pipeline-stages 2`` as two stages of one data row.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_child as child

P = child.P
ULPS = 8
EXACT = ("step", "boundaries", "residual", "volume_elems", "last_volume",
         "wire_bytes", "last_wire_bytes", "last_local_count",
         "last_global_count")
THRESHOLDS = ("local_threshold", "global_threshold", "drift",
              "last_exact_lt")
SPAWN_TIMEOUT_S = 300


def narrow_models(mp):
    """Register ``vgg_narrow`` in both packages' registries (as
    ``test_torch_vgg.py`` does), undone when ``mp`` is."""
    import oktopk_tpu.models.registry as jax_registry
    import oktopk_tpu.models.vgg as jax_vgg
    import oktopk_tpu_torch.models.registry as torch_registry
    import oktopk_tpu_torch.models.vgg as torch_vgg

    for cfgs in (jax_vgg.CFG, torch_vgg.CFG):
        mp.setitem(cfgs, "vgg_narrow", child.NARROW)
    mp.setitem(jax_registry.MODELS, "vgg_narrow",
               lambda **kw: (jax_vgg.VGG(name_cfg="vgg_narrow", **kw),
                             lambda bs: jnp.zeros((bs, 32, 32, 3),
                                                  jnp.float32)))
    mp.setitem(torch_registry.MODELS, "vgg_narrow",
               lambda **kw: torch_vgg.VGG(name_cfg="vgg_narrow", **kw))


def jax_trajectory(mesh, case):
    """JAX's outputs and states (as dicts of arrays, the first the initial
    one) over the case's steps."""
    from oktopk_tpu.collectives.api import batched_init_state, \
        build_allreduce_step
    from oktopk_tpu.config import OkTopkConfig as JaxConfig
    from oktopk_tpu_torch.collectives.state import TENSOR_FIELDS

    name, cfg_kw, steps, warmup, _ = case
    cfg = JaxConfig(**cfg_kw)
    step = build_allreduce_step(name, cfg, mesh, warmup=warmup)
    state = batched_init_state(cfg)

    def arrays(st):
        return {f: np.asarray(getattr(st, f)) for f in TENSOR_FIELDS}

    states, outs = [arrays(state)], []
    for g in child.make_grads(len(steps), seed=1):
        out, state = step(jnp.asarray(g), state)
        outs.append(np.asarray(out))
        states.append(arrays(state))
    return outs, states


def jax_trainer(mesh):
    """The JAX Trainer on the mesh and its initial (params, batch_stats)."""
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.config import TrainConfig as JTrain
    from oktopk_tpu.train.trainer import Trainer as JTrainer

    jt = JTrainer(JTrain(**child.TRAIN), mesh=mesh,
                  algo_cfg=JCfg(**child.TRAIN_ALGO), profile_norm=False)
    return jt, (jax.device_get(jt.state.params),
                jax.device_get(jt.state.model_state["batch_stats"]))


@pytest.fixture(scope="module")
def dist(tmp_path_factory, mesh4):
    """Spawn the four ranks, compute the JAX and stacked sides while they
    run (the JAX states and the weights go to the ranks as files), and
    return all of it."""
    from oktopk_tpu_torch.comm import StackedComm, hierarchical_comm

    d = tmp_path_factory.mktemp("dist")
    cases = child.compressor_cases()
    with pytest.MonkeyPatch.context() as mp:
        narrow_models(mp)
        procs = child.start(child.checks_worker, P, (str(d),))
        try:
            jax_runs = {nm: jax_trajectory(mesh4, c)
                        for nm, c in cases.items() if c[4]}
            child.save({nm: states[:-1] for nm, (_, states)
                        in jax_runs.items()}, str(d / "jax.pt"))
            jt, weights = jax_trainer(mesh4)
            child.save(weights, str(d / "weights.pt"))
            # one thread, as on the ranks: the CPU convolutions' weight
            # gradients add in an order that depends on the thread count
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                stacked = {nm: child.run_compressor(
                    c, StackedComm(P), slice(0, P),
                    jax_runs[nm][1][:-1] if nm in jax_runs else None)
                    for nm, c in cases.items()}
                stacked_hier = {o: child.run_hierarchical(
                    o, hierarchical_comm(child.PODS, P // child.PODS),
                    slice(0, P)) for o in child.HIER_OUTERS}
                stacked_ckpt = {}
                stacked_trainer = child.run_trainer(
                    None, weights, ckpt_dir=str(d / "ckpt_stacked"),
                    ckpt=stacked_ckpt)
                stacked_preempt = child.run_preempt(
                    None, weights, str(d / "parked_stacked"))
                stacked_guarded = child.run_guarded(None, weights)
                stacked_restore = child.run_restore(
                    None, weights, str(d / "restore_stacked"))
                stacked_bert = child.run_bert_trainer(None)
                stacked_resnet = child.run_resnet(None)
                from oktopk_tpu_torch.parallel.bert_pipeline import \
                    make_pipeline_grid
                pgrid = make_pipeline_grid(child.PIPE, P)
                stacked_pipe = (child.pipe_verbs(pgrid),
                                child.run_pipeline(pgrid))
            finally:
                torch.set_num_threads(threads)
            jax_metrics = [jt.train_step(child.train_batch(s))
                           for s in range(3)]
            jax_final = (jax.device_get(jt.state.params),
                         jax.device_get(jt.state.model_state["batch_stats"]))
        finally:
            codes = child.join(procs, SPAWN_TIMEOUT_S)
    errors = {r: (d / f"rank{r}.err").read_text() for r in range(P)
              if (d / f"rank{r}.err").exists()}
    assert codes == [0] * P, (codes, errors)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(P)]
    return {"ranks": ranks, "stacked": stacked, "jax": jax_runs,
            "stacked_hier": stacked_hier,
            "stacked_trainer": stacked_trainer,
            "stacked_ckpt": stacked_ckpt, "dir": d,
            "stacked_preempt": stacked_preempt,
            "stacked_guarded": stacked_guarded,
            "stacked_restore": stacked_restore,
            "stacked_bert": stacked_bert, "stacked_resnet": stacked_resnet,
            "stacked_pipe": stacked_pipe,
            "jax_trainer": (jax_metrics, jax_final)}


def bits(a, b, what):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    if a.is_floating_point():
        a, b = a.float().view(torch.int32), b.float().view(torch.int32)
    assert torch.equal(a, b), what


def assert_ulps(a, b, ulps, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b)), what
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    assert d.max() <= ulps, f"{what}: {d.max()} ulps apart"


def test_every_rank_joined_through_the_launch_layer(dist):
    for r, res in enumerate(dist["ranks"]):
        assert (res["source"], res["rank"], res["size"]) == ("explicit", r,
                                                             P)


def test_api_with_one_worker_per_process(dist):
    """``batched_init_state(comm=)`` gives [1, ...] rows and
    ``time_allreduce_step`` runs its warmup and timed steps at W = 1."""
    for res in dist["ranks"]:
        assert res["timed"] == (2, 3)
        st = res["compressors"]["oktopk sort float32"][0][1]
        assert st["residual"].shape == (1, child.N)


@pytest.mark.parametrize("name", list(child.verb_inputs()))
def test_verb_matches_stacked(dist, name):
    from oktopk_tpu_torch.comm import StackedComm
    x = torch.from_numpy(child.verb_inputs()[name])
    want = child.apply_verb(name, StackedComm(P), x)
    for r, res in enumerate(dist["ranks"]):
        bits(res["verbs"][name], want[r:r + 1], f"{name}, rank {r}")


def test_float_psum_adds_in_rank_order(dist):
    """1e8 + 1 rounds to 1e8 in float32: in rank order the sum is 1; a
    pairwise or ring order gives 2 or 0."""
    x = child.verb_inputs()["psum order-sensitive"][:, 0]
    assert (x[0] + x[2]) + (x[1] + x[3]) == 2.0
    for res in dist["ranks"]:
        assert float(res["verbs"]["psum order-sensitive"]) == 1.0


def test_float_psum_is_one_all_to_all_and_one_all_gather(dist):
    """The rank-order reduce-scatter (H14): one ``all_to_all_single`` out,
    one ``all_gather`` back, nothing else on the wire."""
    for res in dist["ranks"]:
        assert res["psum_calls"] == {"all_to_all_single": 1,
                                     "all_gather": 1}


@pytest.mark.parametrize("name", list(child.compressor_cases()))
def test_compressor_matches_stacked(dist, name):
    """Every step's result and every state field, bit-equal on every
    rank to the stacked comm's row for that rank."""
    want = dist["stacked"][name]
    for r, res in enumerate(dist["ranks"]):
        for i, ((out, st), (w_out, w_st)) in enumerate(
                zip(res["compressors"][name], want)):
            bits(out, w_out[r:r + 1], f"{name} step {i} rank {r}: result")
            for f, v in st.items():
                bits(v, w_st[f][r:r + 1], f"{name} step {i} rank {r}: {f}")


@pytest.mark.parametrize("name", [nm for nm, c in
                                  child.compressor_cases().items() if c[4]])
def test_oktopk_matches_jax(dist, name):
    """One step deep from the JAX state of each step (H1)."""
    outs, states = dist["jax"][name]
    for r, res in enumerate(dist["ranks"]):
        for i, (out, st) in enumerate(res["compressors"][name]):
            np.testing.assert_array_equal(out.numpy()[0], outs[i][r],
                                          err_msg=f"result, step {i}")
            for f in EXACT:
                np.testing.assert_array_equal(
                    st[f][0], states[i + 1][f][r],
                    err_msg=f"{f}, step {i}, rank {r}")
            for f in THRESHOLDS:
                assert_ulps(st[f][0], states[i + 1][f][r], ULPS,
                            f"{f}, step {i}, rank {r}")


def test_topksa_fallback_on_the_host(dist):
    """The process-group comm takes topkSA's dense fallback on the host:
    step 0 (density 1) takes it, step 1 does not; both bit-equal to the
    stacked comm's ``torch.where`` (test_compressor_matches_stacked)."""
    n = child.N
    for res in dist["ranks"]:
        (_, s0), (_, s1) = res["compressors"]["topkSA fallback then sparse"]
        assert float(s0["last_volume"][0]) >= 2.0 * n
        assert float(s1["last_volume"][0]) < 2.0 * n


@pytest.mark.parametrize("outer", child.HIER_OUTERS)
def test_hierarchical_matches_stacked(dist, outer):
    """Rank r is member r % 2 of pod r // 2: its intra group is its pod,
    its inter group the ranks of its member index; every step's result
    and state field bit-equal to the two-level stacked comm's row r."""
    want = dist["stacked_hier"][outer]
    for r, res in enumerate(dist["ranks"]):
        assert res["levels"] == [(P, r), (2, r % 2), (2, r // 2)]
        for i, ((out, st), (w_out, w_st)) in enumerate(
                zip(res["hierarchical"][outer], want)):
            bits(out, w_out[r:r + 1], f"{outer} step {i} rank {r}: result")
            for f, v in st.items():
                bits(v, w_st[f][r:r + 1], f"{outer} step {i} rank {r}: {f}")


def test_replicate_over_a_subgroup(dist):
    """``replicate_`` on the inter group broadcasts from the group's rank
    0, global rank ``r % 2``."""
    for r, res in enumerate(dist["ranks"]):
        assert res["inter_replicate"] == (3 if r >= 2 else 0,
                                          float(r % 2))


def test_trainer_matches_stacked(dist):
    """Per-step losses and metrics, parameters and BatchNorm statistics:
    bit-equal on every rank to the stacked Trainer."""
    want_m, want_sd = dist["stacked_trainer"]
    for r, res in enumerate(dist["ranks"]):
        got_m, got_sd = res["trainer"]
        for s, (gm, wm) in enumerate(zip(got_m, want_m)):
            assert gm.keys() == wm.keys()
            for k in gm:
                bits(gm[k], wm[k], f"rank {r} step {s}: {k}")
        for k in want_sd:
            bits(got_sd[k], want_sd[k], f"rank {r}: {k}")


def test_guard_skips_on_every_rank(dist):
    """A NaN in rank 2's gradient at step 1: every rank skips that step
    (the anomaly counts are psum'd), the health clock advances on each,
    and the parameters and BatchNorm statistics are bit-equal to the
    stacked Trainer's."""
    want_skips, want_health, want_sd = dist["stacked_guarded"]
    assert want_skips == [0, 1, 0] and want_health == (3, 1, 3)
    for r, res in enumerate(dist["ranks"]):
        skips, health, sd = res["guarded"]
        assert (skips, health) == (want_skips, want_health), r
        for k in want_sd:
            bits(sd[k], want_sd[k], f"rank {r}: {k}")


def test_divergence_restore_on_every_rank(dist):
    """A divergence restore across processes: every rank registers the
    checkpoint that ``main_trainer.save_and_register`` wrote, every rank
    reloads it when two consecutive steps skip (the health clock too, so
    the planned NaNs replay), and a write failure that reaches rank 0
    alone makes the next restore unavailable on every rank. The skips,
    the journal's checkpoint and restore records, the supervisor's
    checkpoint fields and the final parameters and BatchNorm statistics
    are the stacked Trainer's, bit for bit."""
    want_skips, want_restored, want_events, want_sup, want_sd = \
        dist["stacked_restore"]
    assert want_skips == [0, 0, 1, 1, 1, 1, 0, 1, 1] and want_restored
    assert want_events == [
        ("checkpoint", 2, "ckpt-2.msgpack"),
        ("restore", 4, "ckpt-2.msgpack"),
        ("checkpoint", 7, "ckpt-7.msgpack"),
        ("restore_unavailable", 9, "")]
    assert want_sup == ("", -1, 1, 2)
    for r, res in enumerate(dist["ranks"]):
        skips, restored, events, sup, sd = res["restore"]
        assert (skips, restored, events, sup) == (
            want_skips, want_restored, want_events, want_sup), r
        for k in want_sd:
            bits(sd[k], want_sd[k], f"rank {r}: {k}")


def test_bert_with_dropout_matches_stacked(dist):
    """bert_tiny, dropout 0.1: rank r derives worker r's dropout keys from
    the step's key alone, as the stacked Trainer's worker r does, so
    losses, metrics and parameters are bit-equal on every rank; and those
    keys and the embedding dropout's mask are JAX's for worker r: the JAX
    Trainer's chain (``PRNGKey(seed + 1)``, a split a step, the worker
    folded in, a split a microbatch) in ``jax.random``, flax's key for
    the site, ``jax.random.bernoulli``."""
    import flax.core.scope as flax_scope

    want_m, want_sd, want_keys = dist["stacked_bert"]
    rng = jax.random.PRNGKey(0 + 1)                 # TrainConfig seed 0
    steps = []
    for _ in range(len(want_keys)):
        rng, sub = jax.random.split(rng)
        steps.append(sub)
    for r, res in enumerate(dist["ranks"]):
        got_m, got_sd, got_keys = res["bert_trainer"]
        for s, (gm, wm) in enumerate(zip(got_m, want_m)):
            assert gm.keys() == wm.keys()
            for k in gm:
                bits(gm[k], wm[k], f"rank {r} step {s}: {k}")
        for k in want_sd:
            bits(got_sd[k], want_sd[k], f"rank {r}: {k}")
        for s, ((keys, mask), (stacked_keys, _)) in enumerate(
                zip(got_keys, want_keys)):
            _, mb = jax.random.split(jax.random.fold_in(steps[s], r))
            np.testing.assert_array_equal(keys[0, 0], np.asarray(mb))
            np.testing.assert_array_equal(keys[0], stacked_keys[r])
            site = flax_scope.LazyRng.create(
                mb, "bert", "embeddings", "Dropout_0", 1).as_jax_rng()
            want = jax.random.bernoulli(site, 0.9, tuple(mask.shape))
            np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
    assert float(want_m[0]["loss"]) != float(want_m[1]["loss"])


def test_pipeline_grid_and_verbs_match_stacked(dist):
    """The data x pipe grid over ``new_group``s (rank d * 2 + s is data row
    d and stage s), and the pipeline's ring hop, broadcast from the last
    stage and stage-order psum of ``to_rows``, values and gradients,
    bit-equal on every rank to the stacked pipe comm's row."""
    want, _ = dist["stacked_pipe"]
    for r, res in enumerate(dist["ranks"]):
        d, s = divmod(r, child.PIPE)
        assert res["pipe_grid"] == (2, child.PIPE, [d], [s], 2, child.PIPE)
        for name, (y, g) in res["pipe_verbs"].items():
            wy, wg = want[name]
            bits(y, wy[r:r + 1], f"{name} value, rank {r}")
            row = r if name != "to_rows" else d
            bits(g, wg[row:row + 1], f"{name} gradient, rank {r}")


def test_sparse_pipeline_matches_stacked(dist):
    """Two sparse pipeline steps (bert_tiny, dropout 0.1, oktopk, pp = 2
    x dp = 2, M = 2): every rank's metrics, its stage's and the shared
    parameters, BertAdam moments and sparse states bit-equal to the
    stacked grid's (its stage's, its data row's)."""
    _, want = dist["stacked_pipe"]
    assert float(want["metrics"][0]["loss"]) != float(
        want["metrics"][1]["loss"])
    for r, res in enumerate(dist["ranks"]):
        d, s = divmod(r, child.PIPE)
        got = res["pipeline"]
        for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
            assert gm.keys() == wm.keys()
            for k in gm:
                bits(gm[k], wm[k], f"rank {r} step {i}: {k}")
        for what, g, w in (("stage", got["stages"][s], want["stages"][s]),
                           ("shared", got["shared"], want["shared"])):
            for j, nm in enumerate(("params", "m", "v")):
                bits(g[j], w[j], f"rank {r} {what} {nm}")
            for f, a in g[3].items():
                bits(torch.from_numpy(a), torch.from_numpy(w[3][f][d:d + 1]),
                     f"rank {r} {what} state {f}")


def test_resnet_step_matches_stacked(dist):
    want_m, want_sd = dist["stacked_resnet"]
    for r, res in enumerate(dist["ranks"]):
        got_m, got_sd = res["resnet"]
        assert got_m.keys() == want_m.keys()
        for k in got_m:
            bits(got_m[k], want_m[k], f"rank {r}: {k}")
        for k in want_sd:
            bits(got_sd[k], want_sd[k], f"rank {r}: {k}")
    assert float(want_m["comm_volume"]) > 0


def test_trainer_checkpoint_is_the_stacked_file(dist):
    """Four ranks' checkpoint (every rank's SparseState row gathered to
    rank 0) holds the stacked Trainer's state bit for bit, and a restore
    on four ranks gives each rank its own row back."""
    from oktopk_tpu_torch.train.checkpoint import read_payload

    assert dist["stacked_ckpt"]["restored"]
    assert all(res["trainer_ckpt"]["restored"] for res in dist["ranks"])
    got = read_payload(str(dist["dir"] / "ckpt_dist" / "ckpt-3.msgpack"))
    want = read_payload(str(dist["dir"] / "ckpt_stacked"
                            / "ckpt-3.msgpack"))
    flat_got = jax.tree_util.tree_flatten_with_path(got["state"])[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want["state"])[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        bits(g, w, jax.tree_util.keystr(path))
    assert got["state"]["sparse_state"]["residual"].shape[0] == P


def test_one_rank_stopped_stops_every_rank(dist):
    """Rank 1 alone asks to stop after step 2 of 4: every rank stops
    there (the ranks agree between steps), every rank's epilogue
    returns 3, and rank 0 parks the gathered state, which is the
    stacked Trainer's parked file bit for bit."""
    from oktopk_tpu_torch.train.checkpoint import read_payload

    assert dist["stacked_preempt"] == (2, 3)
    assert [res["preempt"] for res in dist["ranks"]] == [(2, 3)] * P
    got = read_payload(str(dist["dir"] / "parked_dist" / "local.msgpack.d"
                           / "ckpt-2.msgpack"))
    want = read_payload(str(dist["dir"] / "parked_stacked"
                            / "local.msgpack.d" / "ckpt-2.msgpack"))
    assert got["step"] == want["step"] == 2
    flat_got = jax.tree_util.tree_flatten_with_path(got["state"])[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want["state"])[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        bits(g, w, jax.tree_util.keystr(path))
    assert got["state"]["sparse_state"]["residual"].shape[0] == P


def test_trainer_matches_jax(dist):
    """The tolerances of ``test_torch_vgg.py::
    test_trainer_three_steps_match_jax``, and why, are stated there."""
    from oktopk_tpu_torch.convert import to_jax_params

    jm, (want_p, want_s) = dist["jax_trainer"]
    for res in dist["ranks"]:
        tm, sd = res["trainer"]
        for s in range(3):
            np.testing.assert_allclose(float(tm[s]["loss"]),
                                       float(jm[s]["loss"]), rtol=1e-5)
            for key in ("comm_volume", "local_k", "global_k"):
                assert abs(float(tm[s][key]) - float(jm[s][key])) <= \
                    0.01 * abs(float(jm[s][key])) + 2, (s, key)
        params, stats = to_jax_params(sd)
        for mod in want_p:
            for leaf in want_p[mod]:
                np.testing.assert_allclose(
                    params[mod][leaf], np.asarray(want_p[mod][leaf]),
                    rtol=0, atol=1e-4, err_msg=f"{mod}/{leaf}")
        for mod in want_s:
            for leaf in want_s[mod]:
                np.testing.assert_allclose(
                    stats[mod][leaf], np.asarray(want_s[mod][leaf]),
                    rtol=1e-4, atol=1e-5)


def test_autotune_decides_once_across_ranks(dist):
    """Every rank's calibration, plan, vote and re-tune are rank 0's: the
    probes' and trials' medians are agreed (their max over the ranks),
    and rank 2's regressions fire the re-tune on every rank."""
    results = [res["autotune"] for res in dist["ranks"]]
    want = results[0]
    assert want["first"][0]["source"] == "measured"
    assert want["first"][0]["nsamples"] == 4
    assert all(ms > 0 for _, _, ms in want["first"][1])
    assert want["fired"] == [None, None, {"trigger": "regression",
                                          "signals": [1, 2, 3]}]
    assert want["retune_events"] == 1
    assert [e["signals"] for e in want["retunes"]] == [[1, 2, 3]]
    assert want["feedback"] == (1, 3 + 64, [])
    assert want["names"] == [a for a, _, _ in want["after"][1]]
    assert np.isfinite(want["loss"])
    for r, res in enumerate(results[1:], start=1):
        assert res == want, r


def test_main_trainer_two_ranks(tmp_path):
    """``main_trainer`` on a 2-rank CPU launch (``RANK`` / ``WORLD_SIZE``
    as ``torchrun`` sets them): both ranks exit 0, only rank 0 logs."""
    argv = ["--dnn", "vgg_narrow", "--device", "cpu", "--batch-size", "2",
            "--max-iters", "3", "--warmup-steps", "1", "--log-every", "1",
            "--density", "0.05"]
    codes = child.join(child.start(child.cli_worker, 2,
                                   (str(tmp_path), 2, argv)),
                       SPAWN_TIMEOUT_S)
    errors = [(tmp_path / f"rank{r}.err").read_text() for r in range(2)
              if (tmp_path / f"rank{r}.err").exists()]
    assert codes == [0, 0], errors
    assert [(tmp_path / f"rank{r}.rc").read_text() for r in range(2)] == \
        ["0", "0"]
    log0 = (tmp_path / "rank0.log").read_text()
    assert "2 processes (torchrun, gloo)" in log0, log0
    assert "iter 3 loss" in log0 and "done: 3 iterations" in log0, log0
    assert (tmp_path / "rank1.log").read_text() == ""
    assert not os.environ.get("WORLD_SIZE")


def test_main_bert_pipeline_two_ranks(tmp_path):
    """``main_bert --pipeline-stages 2 --compressor dense`` on a 2-rank
    CPU launch: one data row of two stages, one per process; both ranks
    exit 0, rank 0 logs, and writes the single-module checkpoint with
    rank 1's stage gathered in."""
    argv = ["--model", "bert_tiny", "--device", "cpu", "--batch-size", "2",
            "--pipeline-stages", "2", "--num-microbatches", "2",
            "--compressor", "dense", "--num-minibatches", "2",
            "--log-every", "1", "--ckpt-dir", str(tmp_path / "ckpt")]
    codes = child.join(child.start(child.cli_worker, 2,
                                   (str(tmp_path), 2, argv, "main_bert")),
                       SPAWN_TIMEOUT_S)
    errors = [(tmp_path / f"rank{r}.err").read_text() for r in range(2)
              if (tmp_path / f"rank{r}.err").exists()]
    assert codes == [0, 0], errors
    log0 = (tmp_path / "rank0.log").read_text()
    assert "data=1 x pipe=2" in log0 and "(2 processes)" in log0, log0
    assert "iter 2 loss" in log0 and "saved single-module" in log0, log0
    assert (tmp_path / "rank1.log").read_text() == ""
    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    fresh = bert_to_jax_params(BertForPreTraining(
        BertConfig.tiny()).state_dict())
    tree, step = restore_checkpoint(str(tmp_path / "ckpt"),
                                    {"params": fresh, "model_state": {}})
    assert step == 2
    enc = tree["params"]["bert"]["encoder"]
    assert sorted(enc) == ["layer_0", "layer_1"]
    assert not np.array_equal(enc["layer_1"]["intermediate"]["kernel"],
                              fresh["bert"]["encoder"]["layer_1"]
                              ["intermediate"]["kernel"])


def test_main_bert_two_ranks(tmp_path):
    """``main_bert`` on a 2-rank CPU launch, no longer refused: both ranks
    exit 0, only rank 0 logs, and its log names the two processes."""
    argv = ["--model", "bert_tiny", "--device", "cpu", "--batch-size", "2",
            "--num-minibatches", "2", "--log-every", "1"]
    codes = child.join(child.start(child.cli_worker, 2,
                                   (str(tmp_path), 2, argv, "main_bert")),
                       SPAWN_TIMEOUT_S)
    errors = [(tmp_path / f"rank{r}.err").read_text() for r in range(2)
              if (tmp_path / f"rank{r}.err").exists()]
    assert codes == [0, 0], errors
    log0 = (tmp_path / "rank0.log").read_text()
    assert "2 workers on cpu (2 processes, gloo)" in log0, log0
    assert "iter 2 loss" in log0 and "done: loss" in log0, log0
    assert (tmp_path / "rank1.log").read_text() == ""
