"""The worker side of ``tests/test_torch_dist.py``: what each of the P
gloo processes on the CPU runs, and the cases both sides share.

Spawned processes import this module by name, so it imports ``torch``,
``numpy`` and the port only, never JAX (the parent imports JAX in the
test module). Each worker joins a ``file://`` store under the test's
temporary directory, so parallel test workers never race for a port,
pins torch to one thread, runs every check of its job and writes its
results to ``rank{r}.pt``; an exception is written to ``rank{r}.err``
and the process exits 1.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch

P = 4
N = 1 << 15
NARROW = [8, "M", 16, "M", 16, "M"]


# ---- the comm verbs: (name, inputs [P, ...] from a seed, verb) ---------

def verb_inputs():
    rng = np.random.RandomState(0)
    f32 = np.float32
    order = np.array([[1e8], [1.0], [-1e8], [1.0]], f32)
    return {
        # rank order gives ((1e8 + 1) - 1e8) + 1 = 1; other orders do not
        "psum order-sensitive": order,
        "psum f32": rng.randn(P, 5, 3).astype(f32),
        "psum i32": rng.randint(-1000, 1000, (P, 7)).astype(np.int32),
        "psum i64": rng.randint(-1000, 1000, (P, 7)).astype(np.int64),
        "pmean f32": rng.randn(P, 9).astype(f32),
        "all_gather f32": rng.randn(P, 6).astype(f32),
        "all_gather bf16": rng.randn(P, 6).astype(f32),
        "all_gather i32": rng.randint(0, 99, (P, 2, 3)).astype(np.int32),
        "all_to_all f32": rng.randn(P, P, 5).astype(f32),
        "all_to_all bf16": rng.randn(P, P, 5).astype(f32),
        "all_to_all i32": rng.randint(0, 99, (P, P, 5)).astype(np.int32),
        "all_to_all i64": rng.randint(0, 99, (P, P, 5)).astype(np.int64),
        "ppermute_pair d=1": rng.randn(P, 4).astype(f32),
        "ppermute_pair d=2 i64": rng.randint(0, 99, (P, 4)).astype(np.int64),
        "rank": np.zeros((P, 1), f32),
        # the reduce-scatter pads n to a multiple of P: n = 7, n = 3 < P,
        # and an n-scale float64 row
        "psum f32 n=7": rng.randn(P, 7).astype(f32),
        "psum f32 n=3": rng.randn(P, 3).astype(f32),
        "psum f64 n=1001": rng.randn(P, 1001),
        # the pipeline's hop on the world ring, both ways
        "ppermute_ring s=1": rng.randn(P, 2, 3).astype(f32),
        "ppermute_ring s=-1 i64": rng.randint(0, 99, (P, 4)).astype(
            np.int64),
    }


def count_calls(fn):
    """``fn()``'s calls of the ``torch.distributed`` collectives, by
    name."""
    import torch.distributed as dist
    names = ("all_to_all_single", "all_gather", "all_reduce", "broadcast",
             "reduce_scatter", "all_gather_into_tensor")
    orig = {nm: getattr(dist, nm) for nm in names}
    counts = {}

    def wrap(nm):
        def call(*a, **kw):
            counts[nm] = counts.get(nm, 0) + 1
            return orig[nm](*a, **kw)
        return call

    for nm in names:
        setattr(dist, nm, wrap(nm))
    try:
        fn()
    finally:
        for nm, f in orig.items():
            setattr(dist, nm, f)
    return counts


def apply_verb(name: str, comm, x: torch.Tensor) -> torch.Tensor:
    if "bf16" in name:
        x = x.to(torch.bfloat16)
    verb = name.split()[0]
    if verb == "ppermute_pair":
        return comm.ppermute_pair(x, int(name.split()[1][2:]))
    if verb == "ppermute_ring":
        return comm.ppermute_ring(x, int(name.split()[1][2:]))
    if verb == "rank":
        return comm.rank(x.device)
    return getattr(comm, verb)(x)


# ---- the compressor steps ---------------------------------------------
# name: (registry name, config, steps, warmup, held to JAX). ``steps`` is a
# list of per-step config overrides. Cadences 2/2/3 cover an exact
# recompute, a predicted step and a repartition in three steps.

OKTOPK = dict(n=N, num_workers=P, density=0.02, warmup_steps=0,
              local_recompute_every=2, global_recompute_every=2,
              repartition_every=3)
BASELINE = dict(n=N, num_workers=P, density=0.02, warmup_steps=0,
                local_recompute_every=2)
THREE = [{}, {}, {}]


def compressor_cases():
    cases = {"dense": ("dense", dict(n=N, num_workers=P), [{}], False,
                       False)}
    for method, wire, fuse in (("sort", "float32", None),
                               ("hist", "bfloat16", None),
                               ("bisect", "bfloat16", None),
                               ("hist", "float32", False)):
        cfg = dict(OKTOPK, threshold_method=method, wire_dtype=wire,
                   fuse_select=fuse)
        nm = f"oktopk {method} {wire}" + (" unfused" if fuse is False
                                          else "")
        cases[nm] = ("oktopk", cfg, THREE, False, True)
    for name in ("topkA", "topkA2", "topkAopt", "gtopk", "gaussiank",
                 "topkSA", "gaussiankSA"):
        for wire in ("float32", "bfloat16"):
            cases[f"{name} {wire}"] = (
                name, dict(BASELINE, wire_dtype=wire), THREE, False, False)
    # topkSA forced onto its dense fallback on the first step (density 1:
    # the reduced result is dense) and not on the second
    cases["topkSA fallback then sparse"] = (
        "topkSA", dict(BASELINE, wire_dtype="bfloat16",
                       local_recompute_every=1),
        [{"density": 1.0}, {}], False, False)
    cases["oktopk warmup"] = ("oktopk", dict(OKTOPK, warmup_steps=1,
                                              wire_dtype="bfloat16"),
                              THREE, True, False)
    return cases


def make_grads(steps: int, seed: int):
    rng = np.random.RandomState(seed)
    base = rng.randn(P, N).astype(np.float32)
    return [base + 0.3 * rng.randn(P, N).astype(np.float32)
            for _ in range(steps)]


def run_compressor(case, comm, rows: slice, start_states=None):
    """The case's steps over ``comm`` on the gradient rows ``rows``:
    [(results [W, n], state arrays)] per step. Step i starts from
    ``start_states[i]`` (arrays for all P workers) where given, else from
    the previous step's state."""
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    from oktopk_tpu_torch.collectives.state import SparseState
    from oktopk_tpu_torch.config import OkTopkConfig

    name, cfg_kw, steps, warmup, _ = case
    grads = make_grads(len(steps), seed=1)
    state = batched_init_state(OkTopkConfig(**cfg_kw), "cpu", comm=comm)
    out = []
    for i, over in enumerate(steps):
        cfg = OkTopkConfig(**dict(cfg_kw, **over))
        if start_states is not None:
            state = SparseState.from_numpy(
                {f: np.asarray(v)[rows] for f, v in
                 start_states[i].items()}, "cpu")
        step = build_allreduce_step(name, cfg, comm, warmup=warmup)
        res, state = step(torch.from_numpy(grads[i][rows]), state)
        out.append((res.clone(), state.to_numpy()))
    return out


# the two-level cases: 2 pods x 2, each outer three steps (cadences 2/2/3)
PODS = 2
HIER = dict(OKTOPK, wire_dtype="bfloat16")
HIER_OUTERS = ("dense", "oktopk", "topkA")


def run_hierarchical(outer: str, comm, rows: slice):
    """Three ``hierarchical`` steps with ``outer`` over the two-level
    ``comm`` on the gradient rows ``rows``: [(results, state arrays)]."""
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    from oktopk_tpu_torch.collectives.hierarchical import \
        make_hierarchical_config
    from oktopk_tpu_torch.config import OkTopkConfig

    h = make_hierarchical_config(OkTopkConfig(**HIER), num_pods=PODS,
                                 outer=outer)
    step = build_allreduce_step("hierarchical", h, comm, warmup=False)
    state = batched_init_state(h, "cpu", comm=comm)
    out = []
    for g in make_grads(3, seed=3):
        res, state = step(torch.from_numpy(g[rows]), state)
        out.append((res.clone(), state.to_numpy()))
    return out


def time_steps(comm, rows: slice):
    """``time_allreduce_step`` over ``comm``: (number of timed steps, the
    state's step counter after them)."""
    from oktopk_tpu_torch.collectives import api
    from oktopk_tpu_torch.config import OkTopkConfig
    cfg = OkTopkConfig(**OKTOPK)
    step = api.build_allreduce_step("oktopk", cfg, comm, warmup=False)
    times, state = api.time_allreduce_step(
        step, torch.from_numpy(make_grads(1, seed=2)[0][rows]),
        api.batched_init_state(cfg, "cpu", comm=comm), iters=2)
    return len(times), state.host_step


# ---- the trainer ------------------------------------------------------

TRAIN = dict(dnn="vgg_narrow", batch_size=4, lr=0.05, density=0.05,
             num_workers=P)
TRAIN_ALGO = dict(warmup_steps=1, local_recompute_every=1,
                  global_recompute_every=2)


BERT_TRAIN = dict(dnn="bert_tiny", batch_size=4, lr=4e-4, density=0.02,
                  num_workers=P, total_steps=10, warmup_proportion=0.1)
BERT_ALGO = dict(warmup_steps=0, local_recompute_every=2,
                 global_recompute_every=2, repartition_every=2)


def run_bert_trainer(comm, steps: int = 2):
    """``bert_tiny`` with dropout 0.1 from the seed's weights, ``steps``
    steps: per-step metrics, the state_dict, and per step the dropout
    keys of this process's workers' microbatches ([W, 1, 2], derived as
    the step derives them) with the embedding dropout's keep mask of its
    first worker."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.models.bert import dropout_sites
    from oktopk_tpu_torch.ops import prng
    from oktopk_tpu_torch.train.trainer import Trainer

    tt = Trainer(TrainConfig(**BERT_TRAIN),
                 algo_cfg=OkTopkConfig(**BERT_ALGO), device="cpu",
                 comm=comm)
    cfg, b = tt.model.cfg, BERT_TRAIN["batch_size"]
    metrics, keys = [], []
    for s in range(steps):
        mb = tt.microbatch_keys(prng.split(tt._rng)[1])
        site = prng.flax_site_key(mb[0, 0], dropout_sites(cfg)[0])
        keys.append((mb, prng.keep_mask(site, (b, 32, cfg.hidden_size),
                                        1.0 - cfg.dropout)))
        metrics.append({k: v.clone() for k, v in tt.train_step(
            synthetic_batch("bert_tiny", 16,
                            np.random.RandomState(20 + s))).items()})
    return (metrics, {k: v.clone() for k, v in tt.model.state_dict().items()},
            keys)


# ---- the pipeline: dp = 2 data rows x pp = 2 stages --------------------
# worker d * PIPE + s is data row d and stage s (the JAX device order)

PIPE = 2
PIPE_M = 2


def pipe_verbs(grid):
    """The pipeline's autograd verbs on the pipe comm, on seeded [P, 3, 2]
    inputs (row w = worker w): each verb's value and its input's
    gradient under a seeded cotangent, for this process's rows (the
    stacked grid runs every data row's pipe comm in turn)."""
    from oktopk_tpu_torch.parallel import pipeline as pl
    rng = np.random.RandomState(5)
    x_all = torch.from_numpy(rng.randn(P, 3, 2).astype(np.float32))
    ct_all = torch.from_numpy(rng.randn(P, 3, 2).astype(np.float32))
    out = {}
    for d in grid.data_rows:
        rows = slice(d * PIPE + grid.pipe.first_worker,
                     d * PIPE + grid.pipe.first_worker
                     + grid.pipe.local_workers)
        for name, fn in (("ring_hop", pl.ring_hop),
                         ("bcast_from_last", pl.bcast_from_last)):
            x = x_all[rows].clone().requires_grad_()
            y = fn(x, grid.pipe)
            y.backward(ct_all[rows])
            out.setdefault(name, []).append((y.detach(), x.grad))
        x = x_all[d * PIPE].clone().requires_grad_()
        y = pl.to_rows(x, grid.pipe)
        y.backward(ct_all[rows])
        out.setdefault("to_rows", []).append((y.detach(),
                                              x.grad.unsqueeze(0)))
    return {k: (torch.cat([a for a, _ in v]), torch.cat([b for _, b in v]))
            for k, v in out.items()}


def run_pipeline(grid, steps: int = 2):
    """``bert_tiny`` with dropout 0.1 through the sparse pipeline step
    (oktopk, cadence 2, BertAdam) from the seed's weights, ``steps``
    steps on seeded batches under JAX's step-key chain: per step the
    metrics, then each held stage's and the shared flat parameters and
    BertAdam moments, and every sparse state, with this process's data
    rows."""
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.models.bert import BertConfig
    from oktopk_tpu_torch.models.bert_staged import StagedBertPretrain
    from oktopk_tpu_torch.ops import prng
    from oktopk_tpu_torch.optim import BertAdam
    from oktopk_tpu_torch.parallel import bert_pipeline as bp

    st = StagedBertPretrain(BertConfig.tiny(), PIPE, stages=grid.stages)
    st.init_weights(torch.Generator().manual_seed(3))
    step = bp.build_pipeline_sparse_train_step(
        st, grid, PIPE_M, BertAdam(lr=1e-3, warmup=0.0, t_total=-1),
        OkTopkConfig(density=0.05, warmup_steps=0, local_recompute_every=2,
                     global_recompute_every=2),
        compressor="oktopk", warmup=False)
    rng, metrics = prng.prng_key(11), []
    for s in range(steps):
        pair = prng.split(rng)
        rng = pair[0]
        b = synthetic_batch("bert_tiny", 2 * PIPE_M * 2,
                            np.random.RandomState(30 + s), seq_len=16)
        metrics.append({k: v.clone() for k, v in step(b, pair[1]).items()})
    opt_stage, opt_shared = step.opt_states
    states, shared_state = step.sstates
    stages = {s: (step.stage_buckets[w].flat(step.stage_buckets[w].params)
                  .detach().clone(), opt_stage[w].m.clone(),
                  opt_stage[w].v.clone(), states[w].to_numpy())
              for w, s in enumerate(grid.stages)}
    sb = step.shared_bucket
    return {"metrics": metrics, "stages": stages,
            "shared": (sb.flat(sb.params).detach().clone(),
                       opt_shared.m.clone(), opt_shared.v.clone(),
                       shared_state.to_numpy())}


RESNET_TRAIN = dict(dnn="resnet20", batch_size=2, lr=0.05, density=0.05,
                    num_workers=P, seed=4)


def run_resnet(comm):
    """One oktopk step of resnet20 from the seed's weights (no dense
    warmup), bs 2 a worker: the metrics and the state_dict (the BatchNorm
    statistics rank 0's on every rank)."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.train.trainer import Trainer

    tt = Trainer(TrainConfig(**RESNET_TRAIN),
                 algo_cfg=OkTopkConfig(warmup_steps=0), device="cpu",
                 comm=comm)
    m = tt.train_step(synthetic_batch("resnet20", 2 * P,
                                      np.random.RandomState(30)))
    return ({k: v.clone() for k, v in m.items()},
            {k: v.clone() for k, v in tt.model.state_dict().items()})


def register_narrow():
    import oktopk_tpu_torch.models.registry as registry
    import oktopk_tpu_torch.models.vgg as vgg
    vgg.CFG["vgg_narrow"] = NARROW
    registry.MODELS["vgg_narrow"] = (
        lambda **kw: vgg.VGG(name_cfg="vgg_narrow", **kw))


def train_batch(s: int):
    rng = np.random.RandomState(10 + s)
    return {"image": rng.randn(16, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 10, size=(16,)).astype(np.int32)}


def run_trainer(comm, weights, steps: int = 3, ckpt_dir=None, ckpt=None):
    """Three steps of the narrow VGG from the given flax weights: per-step
    metrics, then the state_dict. With ``ckpt_dir``, then a checkpoint of
    the train state (gathered from every rank, written by rank 0) and its
    restore into a fresh Trainer on the same comm: ``ckpt["restored"]``
    says whether every leaf of this rank's state came back bit for
    bit."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer

    register_narrow()

    def trainer():
        return Trainer(TrainConfig(**TRAIN),
                       algo_cfg=OkTopkConfig(**TRAIN_ALGO), device="cpu",
                       comm=comm)

    tt = trainer()
    tt.load_jax_variables(*weights)
    metrics = [{k: v.clone() for k, v in tt.train_step(train_batch(s))
                .items()} for s in range(steps)]
    if ckpt_dir is not None:
        import torch.distributed as dist

        from oktopk_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)
        state = tt.train_state()                 # every rank: gathers
        if comm is None or comm.first_worker == 0:
            save_checkpoint(ckpt_dir, state, steps)
        if comm is not None:
            dist.barrier()
        fresh = trainer()
        tree, _ = restore_checkpoint(ckpt_dir,
                                     fresh.train_state(gather=False))
        fresh.load_train_state(tree)
        mine = _host_leaves(tt.train_state(host=True, gather=False))
        back = _host_leaves(fresh.train_state(host=True, gather=False))
        ckpt["restored"] = len(mine) == len(back) and all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(mine, back))
    return metrics, {k: v.clone() for k, v in tt.model.state_dict().items()}


def run_guarded(comm, weights, steps: int = 3):
    """The narrow VGG with the anomaly guard and a ``nan_grad`` fault on
    worker 2 at attempted step 1: the per-step skip flags, the health
    clock, then the state_dict. Every rank must take the skip that rank
    2's gradient alone calls for (the psum'd anomaly counts)."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.resilience import FaultPlan, FaultSpec
    from oktopk_tpu_torch.train.trainer import Trainer

    register_narrow()
    plan = FaultPlan((FaultSpec("nan_grad", step=1, worker=2),))
    tt = Trainer(TrainConfig(**TRAIN, resilience=True),
                 algo_cfg=OkTopkConfig(**TRAIN_ALGO), device="cpu",
                 comm=comm, fault_plan=plan)
    tt.load_jax_variables(*weights)
    skips = [int(tt.train_step(train_batch(s))["step_skipped"])
             for s in range(steps)]
    h = tt.grad_step.health
    return (skips, (int(h.step), int(h.steps_skipped), h.host_step),
            {k: v.clone() for k, v in tt.model.state_dict().items()})


def run_restore(comm, weights, ckpt_dir):
    """A divergence restore: the guarded narrow VGG with a divergence
    limit of 2, a cooldown of 3 steps, and ``nan_grad`` on worker 2 at
    attempted steps 2, 3, 5 and 6 of the health clock. Steps 1-2 run
    clean and ``main_trainer.save_and_register`` checkpoints step 2 on
    every rank; steps 3-4 skip and step 4's supervision restores that
    file, the health clock with it, so steps 5-6 replay attempts 2-3
    and skip inside the cooldown; step 7 runs and is checkpointed, then
    a write failure of that file reaches rank 0 alone (as an async
    writer's would), so the restore that steps 8-9 call for is
    unavailable on every rank. Returns the skip flags, whether the state
    right after the restore is step 2's bit for bit, the journal's
    checkpoint and restore records (file names only), the supervisor's
    checkpoint fields, and the final state_dict."""
    from types import SimpleNamespace

    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.resilience import FaultPlan, FaultSpec
    from oktopk_tpu_torch.train.main_trainer import save_and_register
    from oktopk_tpu_torch.train.trainer import Trainer

    register_narrow()
    plan = FaultPlan(tuple(FaultSpec("nan_grad", step=k, worker=2)
                           for k in (2, 3, 5, 6)))
    tt = Trainer(TrainConfig(**TRAIN, resilience=True,
                             resilience_divergence_limit=2,
                             resilience_cooldown=3,
                             resilience_strikes=10),
                 algo_cfg=OkTopkConfig(**TRAIN_ALGO), device="cpu",
                 comm=comm, fault_plan=plan)
    tt.load_jax_variables(*weights)
    rank0 = comm is None or comm.first_worker == 0
    args = SimpleNamespace(ckpt_dir=ckpt_dir, ckpt_keep=0)
    skips = []

    def run(start, n):
        for s in range(start, start + n):
            m = tt.train(iter([train_batch(s)]), 1, start_step=s)
            skips.append(int(m["step_skipped"]))

    def sd():
        return {k: v.clone() for k, v in tt.model.state_dict().items()}

    run(0, 2)
    at_ckpt = sd()
    save_and_register(tt, args, 2, rank0)
    run(2, 2)
    restored = all(torch.equal(v, at_ckpt[k]) for k, v in sd().items())
    run(4, 3)
    path = save_and_register(tt, args, 7, rank0)
    if rank0:
        tt.note_ckpt_failure(7, path, RuntimeError("disk full"))
    run(7, 2)
    sup = tt.supervisor
    events = [(e["event"], e["step"],
               os.path.basename(e.get("path") or e.get("ckpt") or ""))
              for e in sup.journal.entries
              if e["event"] in ("checkpoint", "restore",
                                "restore_unavailable")]
    return (skips, restored, events,
            (os.path.basename(sup.last_good_ckpt or ""),
             sup.last_good_step, sup.ckpt_write_failures,
             sup.restore_events), sd())


def run_preempt(comm, weights, state_dir, stop_after: int = 2,
                steps: int = 4):
    """The CLIs' preemption path on the narrow VGG: ``steps`` steps asked
    for, a stop asked after step ``stop_after`` by rank 1 alone (by the
    one process on the stacked comm), then the epilogue, which parks the
    gathered state under ``state_dir`` (rank 0 writes). Returns (the
    last step run, the epilogue's exit code)."""
    import logging

    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.preemption import (PreemptionHandler,
                                                   epilogue)
    from oktopk_tpu_torch.train.trainer import Trainer

    register_narrow()
    tt = Trainer(TrainConfig(**TRAIN), algo_cfg=OkTopkConfig(**TRAIN_ALGO),
                 device="cpu", comm=comm)
    tt.load_jax_variables(*weights)
    preempt = PreemptionHandler(exit_signals=(), requeue_signals=())
    rank = 0 if comm is None else comm.first_worker
    signalled = comm is None or rank == 1

    def should_stop():
        if signalled and tt.last_step >= stop_after:
            preempt.request_stop()
        return preempt.should_stop()

    tt.train((train_batch(s) for s in range(steps)), steps,
             should_stop=should_stop)
    if tt.last_step < steps:            # another rank may have stopped
        preempt.request_stop()
    rc = epilogue(tt.train_state, tt.last_step, preempt,
                  logging.getLogger("oktopk_tpu_torch.quiet"), rank=rank,
                  completed=tt.last_step >= steps, state_dir=state_dir)
    return tt.last_step, rc


AUTOTUNE_TRAIN = dict(TRAIN, num_buckets=2, autotune=True,
                      autotune_candidates=("dense", "oktopk"),
                      autotune_trial_steps=2, resilience_feedback=True,
                      resilience_feedback_window=8,
                      resilience_feedback_signals=3, obs=True)
REGRESSED_RANK = 2


def run_autotune(comm):
    """The narrow VGG's autotuner over two buckets with real (measured)
    probes and trials, then a step-time regression that rank
    ``REGRESSED_RANK`` alone sees at steps 1-3: the coefficients and the
    plan of the first tune, the retune events, the coefficients and plan
    after the forced re-tune, the feedback state and one planned step's
    loss. Every rank must report the same (the medians are agreed, the
    vote too)."""
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer

    register_narrow()
    tt = Trainer(TrainConfig(**AUTOTUNE_TRAIN),
                 algo_cfg=OkTopkConfig(**TRAIN_ALGO), device="cpu",
                 comm=comm, warmup=False)

    def plan():
        return [(p.algo, p.density, p.measured_ms) for p in tt._plans]

    tt.autotune(step=0)
    first = (tt.autotuner.coeffs.as_dict(), plan())
    rank = 0 if comm is None else comm.first_worker
    fired = []
    for step in (1, 2, 3):
        if rank == REGRESSED_RANK:
            tt.bus.emit("regression", step=step, ms=30.0, baseline_ms=10.0,
                        ratio=3.0)
        fired.append(tt.check_feedback(step))
    retunes = [{k: v for k, v in e.items()}
               for e in tt.run_journal.entries if e["event"] == "retune"]
    after = (tt.autotuner.coeffs.as_dict(), plan())
    fb = (tt.feedback.fired, tt.feedback._cooldown_until,
          list(tt.feedback.signals))
    loss = float(tt.train_step(train_batch(0))["loss"])
    return {"first": first, "fired": fired, "retunes": retunes,
            "retune_events": tt.retune_events, "after": after,
            "feedback": fb, "names": list(tt.grad_step.names),
            "loss": loss}


def _host_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _host_leaves(tree[k])]
    return [] if tree is None else [np.asarray(tree)]


# ---- the worker processes ---------------------------------------------

def _join(rank: int, world: int, init_file: str):
    from oktopk_tpu_torch import launch
    torch.set_num_threads(1)
    return launch.maybe_initialize(
        "gloo", "cpu", env={"OKTOPK_NUM_PROCS": str(world),
                            "OKTOPK_PROC_ID": str(rank)},
        init_method=f"file://{init_file}", timeout_s=120)


def _guard(fn, rank: int, out_dir: str, *args):
    try:
        fn(rank, out_dir, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def save(obj, path: str):
    """``torch.save`` that a reader polling for ``path`` never sees half
    written."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def wait_load(path: str, timeout_s: float = 240.0):
    """Load ``path`` once the parent has written it."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was never written")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _checks(rank: int, out_dir: str):
    from oktopk_tpu_torch.comm import (ProcessGroupComm,
                                       hierarchical_process_comm)
    penv, _ = _join(rank, P, os.path.join(out_dir, "store"))
    comm = ProcessGroupComm()
    row = slice(rank, rank + 1)
    res = {"source": penv.source, "rank": penv.process_id,
           "size": comm.size, "verbs": {}, "compressors": {}}
    for name, x in verb_inputs().items():
        res["verbs"][name] = apply_verb(name, comm,
                                        torch.from_numpy(x[row])).clone()
    x = torch.from_numpy(verb_inputs()["psum f32"][row])
    res["psum_calls"] = count_calls(lambda: comm.psum(x))
    cases = compressor_cases()
    for name, case in cases.items():
        if not case[4]:
            res["compressors"][name] = run_compressor(case, comm, row)
    jax_states = wait_load(os.path.join(out_dir, "jax.pt"))
    for name, states in jax_states.items():
        res["compressors"][name] = run_compressor(cases[name], comm, row,
                                                  states)
    res["timed"] = time_steps(comm, row)
    # two levels over ``new_group``s: every rank creates every group
    hcomm = hierarchical_process_comm(PODS, P // PODS)
    res["levels"] = [(c.size, c.first_worker)
                     for c in (hcomm, hcomm.intra, hcomm.inter)]
    res["hierarchical"] = {o: run_hierarchical(o, hcomm, row)
                           for o in HIER_OUTERS}
    # the inter group's rank 0 is the global rank of this member index
    t = torch.full((3,), float(rank))
    res["inter_replicate"] = (int(hcomm.inter.replicate_([t])), float(t[0]))
    weights = wait_load(os.path.join(out_dir, "weights.pt"))
    res["trainer_ckpt"] = {}
    res["trainer"] = run_trainer(comm, weights,
                                 ckpt_dir=os.path.join(out_dir, "ckpt_dist"),
                                 ckpt=res["trainer_ckpt"])
    res["preempt"] = run_preempt(comm, weights,
                                 os.path.join(out_dir, "parked_dist"))
    res["guarded"] = run_guarded(comm, weights)
    res["restore"] = run_restore(comm, weights,
                                 os.path.join(out_dir, "restore_dist"))
    res["bert_trainer"] = run_bert_trainer(comm)
    res["resnet"] = run_resnet(comm)
    res["autotune"] = run_autotune(comm)
    # the pipeline's grid: every rank creates every group in one order
    from oktopk_tpu_torch.parallel.bert_pipeline import make_pipeline_grid
    grid = make_pipeline_grid(PIPE)
    res["pipe_grid"] = (grid.dp, grid.pp, list(grid.data_rows),
                        list(grid.stages), grid.data.size, grid.pipe.size)
    res["pipe_verbs"] = pipe_verbs(grid)
    res["pipeline"] = run_pipeline(grid)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def checks_worker(rank, out_dir):
    """Spawn target: every comm verb, every compressor case, the
    two-level cases over 2 pods x 2 ``new_group``s, three trainer steps
    and a checkpoint of them, saved and restored, a run stopped by one
    rank and parked, three guarded steps with a NaN on rank 2, a
    divergence restore of a checkpoint, two BERT steps with dropout,
    one resnet20 step, an autotuned run whose regression rank 2 alone
    sees, and the pipeline's verbs and two sparse pipeline steps on a
    2 x 2 data x pipe grid over a 4-rank gloo group.
    The cases held to JAX start from the JAX states the parent writes to
    ``jax.pt``, the trainer from the weights it writes to ``weights.pt``,
    while these run."""
    _guard(_checks, rank, out_dir)


def _cli(rank: int, out_dir: str, world: int, argv, module: str):
    # the launch as ``torchrun`` would describe it; the store is a file
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    _join(rank, world, os.path.join(out_dir, "store"))
    register_narrow()
    import logging
    log = logging.getLogger("oktopk_tpu_torch")
    log.setLevel(logging.INFO)
    log.addHandler(logging.FileHandler(
        os.path.join(out_dir, f"rank{rank}.log")))
    import importlib
    rc = importlib.import_module(f"oktopk_tpu_torch.train.{module}").main(
        argv)
    with open(os.path.join(out_dir, f"rank{rank}.rc"), "w") as f:
        f.write(str(rc))


def cli_worker(rank, out_dir, world, argv, module="main_trainer"):
    """Spawn target: ``oktopk_tpu_torch.train.<module>.main(argv)`` as one
    rank of ``world``."""
    _guard(_cli, rank, out_dir, world, argv, module)


def start(target, world: int, args):
    """Start ``world`` spawned processes of ``target(rank, *args)``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r,) + tuple(args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, timeout_s: float):
    """Join ``procs`` by a deadline and kill the ones still running;
    returns their exit codes (None for one killed at the deadline)."""
    deadline = time.monotonic() + timeout_s
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        codes.append(None if p.is_alive() else p.exitcode)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return codes
