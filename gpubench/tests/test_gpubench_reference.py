"""The plain reference agrees with the program on the CPU, layer by
layer (the model's loss and gradient at ``bert_tiny`` and ``vgg16``
sizes, the exchanges on the same gradients, the optimizers), and through
the harness's whole check at ``bert_tiny`` widths."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import harness, judge, port
from gpubench.reference import exchange_dense as ref_dense
from gpubench.reference import exchange_oktopk as ref_oktopk
from gpubench.reference import optim as ref_optim
from gpubench.reference import prng as ref_prng
from gpubench.reference import train as ref_train
from gpubench.registry import Registry
from gpubench.tests import tiny

REG = Registry()


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_key_algebra_is_the_programs():
    from oktopk_tpu_torch.ops import prng
    key = prng.prng_key(2 ** 31 + 77)
    assert tuple(int(x) for x in key) == ref_prng.prng_key(2 ** 31 + 77)
    assert tuple(int(x) for x in prng.fold_in(key, 3)) == \
        ref_prng.fold_in(ref_prng.prng_key(2 ** 31 + 77), 3)
    assert [tuple(int(x) for x in k) for k in prng.split(key, 3)] == \
        ref_prng.split(ref_prng.prng_key(2 ** 31 + 77), 3)
    site = ("bert", "encoder", "layer_3", "Dropout_0", 2)
    assert prng.site_hash(site) == ref_prng.site_hash(site)
    a = prng.keep_mask(key, (5, 7, 9), 0.9)
    b = ref_prng.keep_mask(ref_prng.prng_key(2 ** 31 + 77), (5, 7, 9), 0.9,
                           "cpu")
    assert torch.equal(a, b)


def _model_pair(name, batch):
    cfg, wl = tiny.cell(name, batch)
    trainer, table, pool = harness.build(REG, cfg, wl, 21, "cpu")
    return cfg, wl, trainer, table, pool


@pytest.mark.parametrize("name,batch", [("bert-base.dense.gb256", 3),
                                        ("vgg16-cifar10.dense.gb2048", 2)])
def test_model_loss_and_gradient_agree(name, batch):
    """One worker's loss and flat gradient, the same weights, rows and
    dropout key, program against reference."""
    cfg, wl, trainer, table, pool = _model_pair(name, batch)
    rows = {k: v[:batch] for k, v in pool[0].items()}
    fam = ref_train.family(cfg["family"])
    key = ref_prng.split(ref_prng.fold_in(ref_prng.prng_key(99), 0))[1]
    loss_p, _ = trainer._loss(rows, 0, np.array(key, dtype=np.uint32))
    loss_p.backward()
    grad_p = torch.cat([port._layout()[1](p.grad, lay).reshape(-1)
                        for _, p, lay in trainer.leaves])
    w = port.flat_params(trainer).requires_grad_(True)
    loss_r = fam.loss(ref_train.views(w, table), rows, cfg["model"],
                      key if fam.uses_dropout(cfg["model"]) else None,
                      "float32")
    loss_r.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()),
                                                   rel=1e-5)
    # float32 sums in another order: norms by leaf within 1e-4
    assert judge.norm_gap(grad_p, w.grad, table) < 1e-4


def test_oktopk_agrees_bit_for_bit_on_the_same_gradients():
    from oktopk_tpu_torch.collectives.oktopk import oktopk
    from oktopk_tpu_torch.collectives.state import init_state
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig
    n, P, d = 60_000, 4, 0.02
    cfg = OkTopkConfig(n=n, num_workers=P, density=d, warmup_steps=0,
                       local_recompute_every=3, global_recompute_every=3,
                       repartition_every=2)
    rc = ref_oktopk.SparseConfig(n=n, workers=P, density=d,
                                 local_recompute_every=3,
                                 global_recompute_every=3,
                                 repartition_every=2)
    st, rs = init_state(cfg, P, "cpu"), ref_oktopk.init_state(rc, "cpu")
    g = torch.Generator().manual_seed(4)
    for _ in range(5):        # exact, predicted, repartition steps
        grad = torch.randn(P, n, generator=g) * torch.linspace(0.1, 2, n)
        out, st = oktopk(grad, st, cfg, StackedComm(P))
        ref, rs, wire = ref_oktopk.allreduce(grad, rs, rc)
        assert torch.equal(out[0], ref)
        assert torch.equal(st.residual, rs["residual"])
        assert float(st.last_wire_bytes[0]) == wire


def test_dense_agrees():
    from oktopk_tpu_torch.comm import StackedComm
    grad = torch.randn(4, 1000, generator=torch.Generator().manual_seed(1))
    ref, _, wire = ref_dense.allreduce(grad, ref_dense.init_state(None,
                                                                  "cpu"))
    assert torch.equal(StackedComm(4).pmean(grad)[0], ref)
    assert wire == 8000.0


def test_optimizers_agree():
    from oktopk_tpu_torch.optim import SGD, BertAdam
    gen = torch.Generator().manual_seed(2)
    p0, g1, g2 = (torch.randn(500, generator=gen) for _ in range(3))
    spec = tiny.load("configs", "bert-base")["training"]
    ours = ref_optim.build(spec)
    theirs = BertAdam(lr=spec["lr"], warmup=spec["warmup_proportion"],
                      t_total=spec["total_steps"])
    theirs.init(500, "cpu")
    p_ref, p_prog = p0.clone(), p0.clone()
    for g in (g1, g2, g1):
        p_ref = ours.step(p_ref, g)
        p_prog = p_prog + theirs.update(g, p_prog)
    torch.testing.assert_close(p_prog, p_ref, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(theirs.m, ours.state(), rtol=1e-6, atol=1e-8)
    spec = tiny.load("configs", "vgg16-cifar10")["training"]
    ours = ref_optim.build(spec)
    theirs = SGD(spec["lr"], spec["momentum"], spec["weight_decay"])
    p_prog = [p0.clone()]
    theirs.init(p_prog)
    p_ref = p0.clone()
    for g in (g1, g2):
        p_ref = ours.step(p_ref, g)
        theirs.update(p_prog, [g])
    torch.testing.assert_close(p_prog[0], p_ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["bert-base.oktopk.gb256",
                                  "bert-base.dense.gb256"])
def test_the_check_passes_a_sound_program(name):
    cfg, wl = tiny.cell(name, 3)
    res = harness.run(REG, REG.cell(name), 2 ** 31 + 5, 0.2, False, "cpu",
                      0.0, config=cfg, workload=wl)
    assert res["correct"], res["checks"]
    assert all(v < 1e-4 for v, _ in res["checks"].values())
