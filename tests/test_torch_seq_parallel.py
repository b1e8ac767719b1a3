"""Sequence parallelism: ring attention (``parallel/ring_attention.py``)
and BERT over a data x seq grid (``parallel/bert_seq.py``) against the
JAX package's on the CPU mesh, and ``main_bert --seq-shards``.

``bert_tiny``, B = 4, T = 32 (``tests/test_bert_seq.py``'s sizes and
batches), the JAX weights carried across as the JAX-layout tree. The
JAX side runs ``use_pallas=False``, the port its kernels' plain
versions. Each JAX program is compiled once per module (the fixtures).

Tolerances, and why:

- ring attention against full attention (JAX's own test) at atol 2e-6:
  the online softmax rescales and adds its blocks in ring order, full
  attention in one softmax (seen 3.3e-7 on values, 7.2e-7 on the
  gradients of q, k and v);
- losses at rtol 1e-6 (seen 1.2e-7): the port's matmuls (MKL) and
  softmax add in their own order, XLA's in its own;
- gradients at atol 2e-6 (seen 4.3e-7 on gradients up to 0.92): the
  same, plus the shards' psum of each parameter's gradient and the tied
  word table's two terms;
- parameters after SGD (lr 0.1) or BertAdam (lr 4e-4) steps at atol 1e-6
  (seen 1.2e-7 after SGD; 2e-6 after BertAdam: its m / sqrt(v) turns a rounding difference of a
  near-zero gradient into up to 3.2 lr, as ``test_torch_bert_pipeline``
  holds it);
- three composed oktopk steps: losses at rtol 1e-6, and each step's
  reduction of the port's own gradient held bit-equal to JAX's oktopk
  fed that same gradient, thresholds within 8 ulps (H1);
- the stacked workers' copies bit-identical (``np.array_equal``).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oktopk_tpu.comm import compat
from oktopk_tpu.models.bert import BertConfig as JaxBertConfig
from oktopk_tpu.models.bert import BertForPreTraining as JaxBert
from oktopk_tpu.parallel import bert_seq as jbs
from oktopk_tpu.parallel.ring_attention import ring_attention as jax_ring
from oktopk_tpu_torch.comm import StackedComm
from oktopk_tpu_torch.config import OkTopkConfig
from oktopk_tpu_torch.convert import bert_from_jax_params, bert_to_jax_params
from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
from oktopk_tpu_torch.models.layout import to_jax_layout
from oktopk_tpu_torch.optim import SGD, BertAdam
from oktopk_tpu_torch.parallel import bert_seq as bs
from oktopk_tpu_torch.parallel.ring_attention import ring_attention
from oktopk_tpu_torch.train import main_bert
from oktopk_tpu_torch.utils.flatten import tree_items

B, T = 4, 32
LOSS_RTOL = 1e-6
GRAD_ATOL = 2e-6
ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """bert_tiny's matrices are too small to share among threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def make_batch(seed, equal_masks=False, t=T, vocab=1024):
    """``tests/test_bert_seq.py``'s batches, as numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, t)).astype(np.int32)
    mlm = np.full((B, t), -1, np.int32)
    amask = np.ones((B, t), np.int32)
    if equal_masks:
        for b in range(B):
            cols = rng.choice(t, size=3, replace=False)
            mlm[b, cols] = ids[b, cols]
    else:
        pos = rng.rand(B, t) < 0.2
        mlm[pos] = ids[pos]
        amask[:, -5:] = 0                  # padding tail crosses shards
    return {"input_ids": ids, "token_type_ids": np.zeros((B, t), np.int32),
            "attention_mask": amask, "mlm_labels": mlm,
            "nsp_labels": rng.randint(0, 2, size=(B,)).astype(np.int32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_params(cfg, t=T):
    ex = jnp.zeros((2, t), jnp.int32)
    rng = jax.random.PRNGKey(0)
    return jax.device_get(JaxBert(cfg).init(
        {"params": rng, "dropout": rng}, ex, ex, jnp.ones_like(ex),
        train=False)["params"])


@pytest.fixture(scope="module")
def jparams():
    return jax_params(JaxBertConfig.tiny())


def requires_grad(tree):
    return {k: requires_grad(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.requires_grad_()


def grads_of(tree):
    return [x.grad.numpy() for _, x in tree_items(tree)]


def assert_trees_close(want, got, atol, what):
    wl, gl = tree_items(want), tree_items(got)
    assert [p for p, _ in wl] == [p for p, _ in gl], what
    for (path, w), (_, g) in zip(wl, gl):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


def assert_ulps(a, b, ulps, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b)), what
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    assert d.max() <= ulps, f"{what}: {d.max()} ulps apart"


def oracle(jparams, batch):
    """The port's single module (no dropout) on ``batch``: the pretraining
    loss and its gradient as the JAX-layout flat vector."""
    m = BertForPreTraining(BertConfig.tiny(dropout=0.0))
    m.load_state_dict(bert_from_jax_params(jparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mlm, nsp = m(tb["input_ids"], tb["token_type_ids"],
                 tb["attention_mask"], train=False)
    labels = tb["mlm_labels"]
    mask = (labels >= 0).float()
    per_tok = torch.nn.functional.cross_entropy(
        mlm.flatten(0, 1), labels.clamp(min=0).long().flatten(),
        reduction="none").view(labels.shape)
    loss = ((per_tok * mask).sum() / mask.sum().clamp(min=1.0)
            + torch.nn.functional.cross_entropy(nsp,
                                                tb["nsp_labels"].long()))
    loss.backward()
    return float(loss.detach()), torch.cat([
        to_jax_layout(p.grad, lay).reshape(-1)
        for _, p, lay in m.jax_leaves()]).numpy()


# ---- ring attention ----------------------------------------------------------

def shards(x, P):
    """[B, T, H, D] -> [P, B, T/P, H, D]."""
    b, t = x.shape[:2]
    return x.reshape((b, P, t // P) + x.shape[2:]).movedim(1, 0)


def unshard(x):
    return x.movedim(0, 1).flatten(1, 2)


def full_attention(q, k, v, mask=None):
    s = torch.einsum("bthd,bshd->bths", q * q.shape[-1] ** -0.5, k)
    if mask is not None:
        s = torch.where(mask[:, None, None, :], s, torch.tensor(-1e30))
    return torch.einsum("bths,bshd->bthd", torch.softmax(s, -1), v)


def qkv(seed, b, t, h, d):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("P", [1, 2, 4])
def test_ring_attention_matches_full_attention(P):
    """Values and the gradients of q, k and v (the backward hops back)."""
    q, k, v = qkv(42, 2, 16, 2, 8)
    ct = torch.from_numpy(np.random.RandomState(7).randn(2, 16, 2, 8)
                          .astype(np.float32))
    want = full_attention(*[x.clone().requires_grad_() for x in (q, k, v)])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = full_attention(*leaves)
    ref.backward(ct)
    mine = [x.clone().requires_grad_() for x in (q, k, v)]
    got = unshard(ring_attention(*[shards(x, P) for x in mine],
                                 StackedComm(P)))
    got.backward(ct)
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy(), atol=2e-6)
    for a, b in zip(mine, leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=2e-6)


def test_ring_self_attention_matches_full_attention():
    """The projections, ring attention and the output projection over 4
    shards against the same projections around full attention."""
    from oktopk_tpu_torch.parallel.ring_attention import ring_self_attention
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 16, 12).astype(np.float32))
    wq, wk, wv = (torch.from_numpy(0.3 * rng.randn(12, 8).astype(np.float32))
                  for _ in range(3))
    wo = torch.from_numpy(0.3 * rng.randn(8, 12).astype(np.float32))
    got = unshard(ring_self_attention(shards(x, 4), wq, wk, wv, wo, 2,
                                      StackedComm(4)))

    def proj(w):
        return (x @ w).reshape(2, 16, 2, 4)
    want = full_attention(proj(wq), proj(wk), proj(wv)).reshape(2, 16, 8) @ wo
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


def test_ring_attention_respects_padding_mask():
    q, k, v = qkv(42, 1, 8, 1, 4)
    mask = torch.tensor([[1, 1, 1, 1, 1, 1, 0, 0]], dtype=torch.bool)
    got = unshard(ring_attention(*[shards(x, 4) for x in (q, k, v)],
                                 StackedComm(4),
                                 kv_mask=shards(mask, 4)))
    np.testing.assert_allclose(got.numpy(),
                               full_attention(q, k, v, mask).numpy(),
                               atol=2e-6)
    # the masked keys take no part: changing them changes nothing
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:], v2[:, 6:] = 7.0, -3.0
    again = unshard(ring_attention(*[shards(x, 4) for x in (q, k2, v2)],
                                   StackedComm(4),
                                   kv_mask=shards(mask, 4)))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)


def test_ring_attention_matches_jax(mesh4):
    """The same shards through JAX's ``ring_attention`` on a 4-device
    mesh, with a padding mask."""
    from jax.sharding import PartitionSpec as P
    q, k, v = qkv(3, 2, 16, 2, 8)
    mask = np.ones((2, 16), bool)
    mask[1, -5:] = False
    sh = [shards(x, 4) for x in (q, k, v)]
    msh = shards(torch.from_numpy(mask), 4)

    def f(q_, k_, v_, m_):
        return jax_ring(q_[0], k_[0], v_[0], "data", kv_mask=m_[0])[None]

    want = jax.jit(compat.shard_map(
        f, mesh=mesh4, in_specs=(P("data"),) * 4, out_specs=P("data")))(
        *[jnp.asarray(x.numpy()) for x in sh], jnp.asarray(msh.numpy()))
    got = ring_attention(*sh, StackedComm(4), kv_mask=msh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


# ---- the loss and its gradients --------------------------------------------

GRIDS = [(2, 1), (4, 1), (8, 1), (4, 2)]


@pytest.fixture(scope="module")
def jax_losses(jparams):
    """JAX's ``build_seq_loss`` on batch 1 at each (sp, dp), and its
    gradient at sp = 4 on batch 2."""
    cfg = JaxBertConfig.tiny()
    b1 = jbatch(make_batch(1))
    losses = {g: float(jbs.build_seq_loss(
        cfg, jbs.make_seq_mesh(g[0], data_size=g[1]))(jparams, b1))
        for g in GRIDS}
    loss4 = jbs.build_seq_loss(cfg, jbs.make_seq_mesh(4))
    b2 = jbatch(make_batch(2))
    grads = jax.device_get(jax.grad(lambda p: loss4(p, b2))(jparams))
    return losses, grads


@pytest.mark.parametrize("sp,dp", GRIDS)
def test_loss_matches_jax(jparams, jax_losses, sp, dp):
    got = float(bs.build_seq_loss(BertConfig.tiny(), bs.make_seq_grid(
        sp, dp))(bs.tree_to_torch(jparams), make_batch(1)))
    np.testing.assert_allclose(got, jax_losses[0][(sp, dp)],
                               rtol=LOSS_RTOL)


def test_loss_matches_single_module(jparams):
    want, _ = oracle(jparams, make_batch(1))
    got = float(bs.build_seq_loss(BertConfig.tiny(), bs.make_seq_grid(
        4, 2))(bs.tree_to_torch(jparams), make_batch(1)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def seq_grads(jparams, batch, sp=4, dp=1):
    tree = requires_grad(bs.tree_to_torch(jparams))
    bs.build_seq_loss(BertConfig.tiny(), bs.make_seq_grid(sp, dp))(
        tree, batch).backward()
    return tree


def test_gradients_match_jax(jparams, jax_losses):
    """The shard_map transposes: the shards' psum of each parameter's
    gradient (``pvary``), the [CLS] psum and the loss psums each row's
    own cotangent (``psum``), the pooler's gradient once."""
    tree = seq_grads(jparams, make_batch(2))
    for (path, w), g in zip(tree_items(jax_losses[1]), grads_of(tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=GRAD_ATOL, err_msg="/".join(path))


@pytest.mark.parametrize("sp,dp", [(4, 1), (2, 2)])
def test_gradients_match_single_module(jparams, sp, dp):
    _, want = oracle(jparams, make_batch(2))
    tree = seq_grads(jparams, make_batch(2), sp, dp)
    got = np.concatenate([g.reshape(-1) for g in grads_of(tree)])
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL)


def test_bfloat16_rounds_the_table_only(jparams):
    """``--compute-dtype bfloat16`` on the seq path: JAX's ``bert_seq``
    casts only the tied MLM table (``h`` stays float32, the product
    promotes to float32); the loss equals JAX's in bfloat16 and differs
    from float32's."""
    jcfg = JaxBertConfig.tiny(dtype=jnp.bfloat16)
    b = make_batch(1)
    want = float(jbs.build_seq_loss(jcfg, jbs.make_seq_mesh(2))(
        jparams, jbatch(b)))
    cfg = BertConfig.tiny(dtype=torch.bfloat16)
    got = float(bs.build_seq_loss(cfg, bs.make_seq_grid(2))(
        bs.tree_to_torch(jparams), b))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    f32 = float(bs.build_seq_loss(BertConfig.tiny(), bs.make_seq_grid(2))(
        bs.tree_to_torch(jparams), b))
    assert got != f32


def test_widened_positions_convert_and_run():
    """T = 256 past bert_tiny's 128 positions (the CLI widens the table,
    JAX's :405-408): the widened tree converts both ways and the seq loss
    at sp = 2 equals the single module's."""
    import dataclasses
    cfg = dataclasses.replace(BertConfig.tiny(dropout=0.0), max_position=256)
    m = BertForPreTraining(cfg)
    m.init_weights(torch.Generator().manual_seed(1))
    tree = bert_to_jax_params(m.state_dict())
    assert tree["bert"]["embeddings"]["position_embeddings"][
        "embedding"].shape == (256, 64)
    back = bert_from_jax_params(tree)
    assert all(torch.equal(back[k], v) for k, v in m.state_dict().items())
    b = make_batch(4, t=256)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    mlm, nsp = m(tb["input_ids"], tb["token_type_ids"],
                 tb["attention_mask"], train=False)
    got = float(bs.build_seq_loss(cfg, bs.make_seq_grid(2))(
        bs.tree_to_torch(tree), b))
    mask = (tb["mlm_labels"] >= 0).float()
    per_tok = torch.nn.functional.cross_entropy(
        mlm.flatten(0, 1), tb["mlm_labels"].clamp(min=0).long().flatten(),
        reduction="none").view(B, 256)
    want = float(((per_tok * mask).sum() / mask.sum()
                  + torch.nn.functional.cross_entropy(
                      nsp, tb["nsp_labels"].long())).detach())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def saved_activation_bytes(jparams, sp):
    """Bytes autograd saves in one fwd+bwd of a data row's loss at ``sp``
    shards (dp = 1) over every stacked worker, the parameter rows
    themselves left out, and divided by the workers."""
    from oktopk_tpu_torch.utils.flatten import TreeLayout
    cfg = BertConfig.tiny()
    grid = bs.make_seq_grid(sp)
    tree = bs.tree_to_torch(jparams)
    layout = TreeLayout(tree)
    p = layout.flat(tree).expand(sp, -1).clone().requires_grad_()
    own = p.untyped_storage().data_ptr()
    total = 0

    def pack(t):
        nonlocal total
        if t.untyped_storage().data_ptr() != own:
            total += t.numel() * t.element_size()
        return t

    row = {k: torch.from_numpy(v) for k, v in make_batch(9).items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = bs._row_loss(p, layout, bs.shard_batch(row, grid), cfg, grid)
    loss.backward(torch.ones_like(loss))
    return total / sp


def test_activation_memory_scales_with_seq_shards(jparams):
    """The long-context property: the activations a worker saves for its
    backward fall near-linearly with the shards (no [T, T] scores, the
    position-wise tensors split on the token axis). JAX measured its
    compiled program's temporaries at ~0.26x at sp = 4."""
    share = {sp: saved_activation_bytes(jparams, sp) for sp in (1, 4)}
    assert share[4] < 0.6 * share[1], share


# ---- the composed steps -------------------------------------------------------

def jax_sparse_step(jparams, compressor, accum=1):
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu.optim.sgd import sgd
    n = sum(x.size for x in jax.tree.leaves(jparams))
    acfg = JCfg(n=n, num_workers=2, density=0.05, warmup_steps=0,
                use_pallas=False)
    opt = sgd(lr=0.1)
    step = jbs.build_seq_sparse_train_step(
        JaxBertConfig.tiny(), jbs.make_seq_mesh(4, data_size=2), opt, acfg,
        compressor=compressor, warmup=False, accum_steps=accum)
    return step, acfg, opt


def jax_run(jparams, compressor, batches, accum=1):
    from oktopk_tpu.collectives.state import init_state
    step, acfg, opt = jax_sparse_step(jparams, compressor, accum)
    p = jbs.stack_replicas(jparams, 2)
    ss = jbs.stack_replicas(init_state(acfg), 2)
    o = jbs.stack_replicas(opt.init(jparams), 2)
    losses = []
    for b in batches:
        p, ss, o, loss = step(p, ss, o, jbatch(b))
        losses.append(float(loss))
    return jax.device_get(p), jax.device_get(ss), losses


@pytest.fixture(scope="module")
def jax_steps(jparams):
    """JAX's composed dp 2 x sp 4 step: dense one step, oktopk three,
    accumulation of 2 against 1 (dense, equal mask counts)."""
    eq = make_batch(17, equal_masks=True)
    return {"dense": jax_run(jparams, "dense", [make_batch(11)]),
            "oktopk": jax_run(jparams, "oktopk", [make_batch(12)] * 3),
            "acc1": jax_run(jparams, "dense", [eq]),
            "acc2": jax_run(jparams, "dense", [eq], accum=2)}


def port_step(jparams, compressor, accum=1, density=0.05):
    return bs.build_seq_sparse_train_step(
        BertConfig.tiny(), bs.make_seq_grid(4, 2), bs.tree_to_torch(jparams),
        SGD(0.1), OkTopkConfig(density=density, warmup_steps=0),
        compressor=compressor, warmup=False, accum_steps=accum)


def test_dense_composition_matches_jax_and_the_oracle(jparams, jax_steps):
    """compressor ``dense``: the mean of the per-data-row gradients, held
    to JAX's composed step and to the port's single module on each
    half-batch."""
    step = port_step(jparams, "dense")
    b = make_batch(11)
    m = step(b)
    jp, _, jl = jax_steps["dense"]
    np.testing.assert_allclose(float(m["loss"]), jl[0], rtol=LOSS_RTOL)
    assert step.replicas_equal()
    assert_trees_close(jax.tree.map(lambda x: x[0], jp), step.tree(), 1e-6,
                       "params")
    halves = [oracle(jparams, {k: v[h * 2:(h + 1) * 2]
                               for k, v in b.items()})[1] for h in (0, 1)]
    flat0 = np.concatenate([np.asarray(x).reshape(-1)
                            for _, x in tree_items(jparams)])
    # SGD's first step: the momentum buffer is the gradient
    want = flat0 - 0.1 * (halves[0] + halves[1]) / 2
    got = step.params[0].detach()[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_oktopk_composition_three_steps(jparams, jax_steps):
    """oktopk over data under ring attention over seq: the state
    advances, the volume is sparse, the parameters move and every worker
    copy stays bit-identical; the losses are JAX's; each step's reduction
    is JAX's oktopk on the same gradient."""
    from oktopk_tpu.collectives.api import batched_init_state, \
        build_allreduce_step
    from oktopk_tpu.comm import get_mesh
    from oktopk_tpu.config import OkTopkConfig as JCfg
    from oktopk_tpu_torch.collectives.state import SparseState

    step = port_step(jparams, "oktopk")
    n = step.layout.n
    _, jss, jl = jax_steps["oktopk"]
    jcfg = JCfg(n=n, num_workers=2, density=0.05, warmup_steps=0,
                use_pallas=False)
    jstep = build_allreduce_step("oktopk", jcfg, get_mesh(
        (2,), ("data",), devices=jax.devices()[:2]), warmup=False)
    jstate = batched_init_state(jcfg)
    b = make_batch(12)
    flat0 = step.params[0].detach()[0].clone()
    for i in range(3):
        before = SparseState.from_numpy(step.sstates[0].to_numpy(), "cpu")
        m = step(b)
        np.testing.assert_allclose(float(m["loss"]), jl[i], rtol=LOSS_RTOL)
        assert step.replicas_equal(), i
        vol = float(m["comm_volume"])
        assert 0 < vol < 2.0 * n, vol
        # the reduction: JAX's oktopk on the gradient the port fed its own
        g = step.g[0].numpy()
        jout, jstate = jstep(jnp.asarray(g), jstate)
        out, _ = step.algo(step.g[0].clone(), before, step.algo_cfg,
                           step.grid.data)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        for f in ("local_threshold", "global_threshold"):
            assert_ulps(getattr(step.sstates[0], f).numpy(),
                        np.asarray(getattr(jstate, f)), ULPS, f)
    assert [int(s.step[0]) for s in step.sstates] == [3] * 4
    assert int(np.asarray(jss.step)[0]) == 3
    assert float(torch.sum((step.params[0].detach()[0] - flat0) ** 2)) > 0


def test_accumulation_matches_full_batch(jparams, jax_steps):
    """accum_steps = 2 on half-batches equals one step on the full batch
    (dense compressor, equal mask counts), in the port and in JAX."""
    b = make_batch(17, equal_masks=True)
    runs = {}
    for acc in (1, 2):
        step = port_step(jparams, "dense", accum=acc)
        runs[acc] = (float(step(b)["loss"]), step.tree())
        jp, _, jl = jax_steps[f"acc{acc}"]
        np.testing.assert_allclose(runs[acc][0], jl[0], rtol=LOSS_RTOL)
        assert_trees_close(jax.tree.map(lambda x: x[0], jp), runs[acc][1],
                           1e-6, f"accum {acc}")
    np.testing.assert_allclose(runs[1][0], runs[2][0], rtol=LOSS_RTOL)
    assert_trees_close(runs[1][1], runs[2][1], 1e-6, "accum 2 vs 1")


def test_dense_train_step_matches_jax(jparams):
    """The CLI's dense form (JAX's ``build_seq_train_step`` over the
    composed dp 2 x sp 2 loss): one copy, BertAdam."""
    from oktopk_tpu.optim.bert_adam import bert_adam
    opt = bert_adam(lr=4e-4, warmup=0.0, t_total=-1)
    jstep = jbs.build_seq_train_step(JaxBertConfig.tiny(),
                                     jbs.make_seq_mesh(2, data_size=2), opt)
    b = make_batch(13)
    jp, _, jloss = jstep(jparams, opt.init(jparams), jbatch(b))
    step = bs.build_seq_train_step(
        BertConfig.tiny(), bs.make_seq_grid(2, 2), bs.tree_to_torch(jparams),
        BertAdam(lr=4e-4, warmup=0.0, t_total=-1))
    m = step(b)
    np.testing.assert_allclose(float(m["loss"]), float(jloss),
                               rtol=LOSS_RTOL)
    assert len(step.params) == 1 and step.params[0].dim() == 1
    assert_trees_close(jax.device_get(jp), step.tree(), 2e-6, "params")


def test_seq_grid_and_bucket_sizes():
    """The grid's layout, and BERT-base's one bucket: n = 110,106,428 at
    T <= 512, 111,286,076 with the position table widened to 2048."""
    import dataclasses
    g = bs.make_seq_grid(4, 2)
    assert (g.dp, g.sp, g.data.size, g.seq.size) == (2, 4, 2, 4)
    assert list(g.shards) == [0, 1, 2, 3] and list(g.data_rows) == [0, 1]
    assert not g.distributed
    for t, n in ((512, 110106428), (2048, 111286076)):
        cfg = BertConfig.base()
        if t > cfg.max_position:
            cfg = dataclasses.replace(cfg, max_position=t)
        with torch.device("meta"):
            m = BertForPreTraining(cfg)
        assert sum(x.numel() for _, x in tree_items(bs.jax_tree(m))) == n


def test_shard_batch_splits_tokens():
    g = bs.make_seq_grid(4)
    row = {k: torch.from_numpy(v) for k, v in make_batch(3).items()}
    sh = bs.shard_batch(row, g)
    assert sh["input_ids"].shape == (4, B, T // 4)
    assert torch.equal(sh["input_ids"].permute(1, 0, 2).reshape(B, T),
                       row["input_ids"])
    assert sh["nsp_labels"].shape == (4, B)


# ---- the CLI ------------------------------------------------------------------

SEQ_ARGV = ["--model", "bert_tiny", "--device", "cpu", "--seq-shards", "2",
            "--seq-data-shards", "2", "--num-minibatches", "2",
            "--log-every", "1", "--batch-size", "2"]


def test_main_bert_seq_sparse_and_dense(tmp_path, caplog, jparams):
    """``main_bert --seq-shards 2 --seq-data-shards 2``, sparse then
    dense: JAX's log line, a checkpoint that JAX's ``restore_checkpoint``
    reads into the JAX template, and ``--resume`` a warm start from it."""
    import logging
    from oktopk_tpu.train.checkpoint import restore_checkpoint as jrestore
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    caplog.set_level(logging.INFO, logger="oktopk_tpu_torch.bert")
    ck = tmp_path / "ck"
    assert main_bert.main(SEQ_ARGV + ["--ckpt-dir", str(ck)]) == 0
    lines = [r.getMessage() for r in caplog.records]
    iters = [x for x in lines if x.startswith("iter ")]
    assert len(iters) == 2, lines
    assert all(re.fullmatch(r"iter \d+ loss \d+\.\d{4} \d+\.\d{3}s/it", x)
               for x in iters), iters
    assert any("T=32 over 2 shards" in x for x in lines), lines
    tree, step = jrestore(str(ck), {"params": jparams, "model_state": {}})
    assert step == 2
    mine, _ = restore_checkpoint(str(ck), {"params": jparams,
                                           "model_state": {}})
    for (pa, a), (_, b) in zip(tree_items(tree["params"]),
                               tree_items(mine["params"])):
        assert np.array_equal(np.asarray(a), np.asarray(b)), pa
    caplog.clear()
    assert main_bert.main(SEQ_ARGV + ["--compressor", "dense", "--resume",
                                      str(ck)]) == 0
    assert any("warm-started" in r.getMessage() for r in caplog.records)


def test_main_bert_seq_builder_starts_from_the_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    assert main_bert.main(SEQ_ARGV + ["--ckpt-dir", str(ck)]) == 0
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint
    args = main_bert.parse_args(SEQ_ARGV + ["--resume", str(ck),
                                            "--compute-dtype", "bfloat16",
                                            "--gradient-accumulation-steps",
                                            "2"])
    run = main_bert.build_seq(args)
    assert run.cfg.dtype == torch.bfloat16 and run.step.accum_steps == 2
    saved, _ = restore_checkpoint(str(ck), run.checkpoint_payload())
    for (pa, a), (_, b) in zip(tree_items(saved["params"]),
                               tree_items(run.step.tree())):
        assert np.array_equal(np.asarray(a), b.numpy()), pa
    assert run.step.replicas_equal()
    m = run.train_step()
    assert np.isfinite(float(m["loss"])) and float(m["comm_volume"]) > 0
    assert len(next(run.data)["input_ids"]) == 2 * 2 * 2


@pytest.mark.parametrize("extra,message", [
    (["--seq-shards", "3"], "must divide by --seq-shards"),
    (["--seq-shards", "2"], "no data axis"),
    (["--seq-shards", "2", "--compressor", "dense",
      "--gradient-accumulation-steps", "2"], "composed sparse form"),
    (["--seq-data-shards", "2"], "needs --seq-shards > 1"),
])
def test_main_bert_seq_refusals(extra, message):
    with pytest.raises(SystemExit, match=message):
        main_bert.main(["--model", "bert_tiny", "--device", "cpu",
                        "--num-minibatches", "1"] + extra)
