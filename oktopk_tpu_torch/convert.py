"""Map the flax model variables onto the port's ``state_dict`` and back.

``from_jax_params`` takes the flax ``params`` (and ``batch_stats``)
trees as nested dicts of numpy arrays and returns a ``state_dict``;
``to_jax_params`` is its inverse (it also maps gradients, for the
flat-gradient comparison). Both dispatch on the ``model`` they are
given (``Trainer.load_jax_variables`` gives its own): a
``BertForPreTraining``, a ``FlaxNamedModule`` or a VGG. A flax tree alone
cannot say which: AlexNet's roots (``Conv_*``, ``Dense_0``) are also
VGG's. Without a model, a BERT tree is told by its ``bert`` root, a
DeepSpeech or PTB tree by ``BatchRNN_0`` or ``Embed_0``, and the rest is
taken for VGG; a state_dict by its keys (VGG's ``convs.``, ``bns.``,
``dense.``; BERT's roots; a flax-named model's capitalised flax names).

- VGG (``models.vgg.VGG``): conv kernels HWIO -> OIHW, the Dense kernel
  [in, out] -> the Linear weight [out, in], BatchNorm ``scale``/``bias``
  and the ``mean``/``var`` statistics by name;
- BERT (``models.bert.BertForPreTraining``): each flax path maps to one
  ``state_dict`` key and layout (``models.bert.torch_key``): Dense
  kernels transposed, ``DenseGeneral`` kernels, embedding tables and the
  rest as they are;
- the flax-named models (DeepSpeech, the PTB LSTM and the CNN zoo,
  ``models.layout.FlaxNamedModule``): each flax path of ``params`` and
  of ``batch_stats`` is one ``state_dict`` key
  (``models.layout.flax_named_key``): conv kernels HWIO -> OIHW, Dense
  and LSTM kernels transposed, the rest as they are.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

from oktopk_tpu_torch.models.bert import (BertForPreTraining,
                                          BertForSequenceClassification,
                                          flax_path, torch_key)
from oktopk_tpu_torch.models.layout import (FlaxNamedModule, flax_named_key,
                                            flax_named_path,
                                            from_jax_layout, to_jax_layout)

_CONV = re.compile(r"^Conv_(\d+)$")
_BN = re.compile(r"^BatchNorm_(\d+)$")


_BERT_ROOTS = ("bert", "mlm_bias", "mlm_dense", "mlm_ln", "nsp")


def _is_bert_tree(params_np) -> bool:
    return "bert" in params_np


def _is_bert_state(tensors) -> bool:
    return any(k.split(".")[0] in _BERT_ROOTS for k in tensors)


_FLAX_NAMED_ROOTS = ("BatchRNN_0", "Embed_0")


def _is_flax_named_tree(params_np) -> bool:
    return any(r in params_np for r in _FLAX_NAMED_ROOTS)


_FLAX_NAME = re.compile(r"^[A-Z][A-Za-z]*_\d+$")


def _is_flax_named_state(tensors) -> bool:
    return any(_FLAX_NAME.match(k.split(".")[0]) for k in tensors)


def _family(model, tree_says: str) -> str:
    """"bert", "flax_named" or "vgg": the model's, else the tree's."""
    if model is None:
        return tree_says
    if isinstance(model, (BertForPreTraining,
                          BertForSequenceClassification)):
        return "bert"
    return "flax_named" if isinstance(model, FlaxNamedModule) else "vgg"


def _walk(tree, prefix=""):
    """(flax path, leaf) of a nested dict, depth first."""
    for name, sub in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(sub, Mapping):
            yield from _walk(sub, path)
        else:
            yield path, sub


def _set(tree: dict, path: str, value) -> None:
    parts = path.split("/")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def flax_named_from_jax(params_np, batch_stats_np=None
                        ) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a flax-named model (DeepSpeech, the PTB LSTM)
    from the flax params and batch_stats."""
    sd = {}
    for tree in (params_np, batch_stats_np or {}):
        for path, a in _walk(tree):
            key, layout = flax_named_key(path)
            t = torch.from_numpy(np.array(a, np.float32, copy=True))
            sd[key] = from_jax_layout(t, layout).contiguous()
    return sd


def flax_named_to_jax(tensors: Dict[str, torch.Tensor]
                      ) -> Tuple[dict, dict]:
    """Inverse of ``flax_named_from_jax``: (params, batch_stats)."""
    params, stats = {}, {}
    for key, t in tensors.items():
        path, layout = flax_named_path(key)
        a = np.ascontiguousarray(
            to_jax_layout(t.detach().cpu(), layout).numpy())
        _set(stats if path.rsplit("/", 1)[-1] in ("mean", "var")
             else params, path, a)
    return params, stats


def _tensor(a, layout: str) -> torch.Tensor:
    a = np.asarray(a)
    if layout == "linear":
        a = a.T
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def bert_from_jax_params(params_np) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``BertForPreTraining`` from the flax params."""
    sd = {}
    for path, a in _walk(params_np):
        key, layout = torch_key(path)
        sd[key] = _tensor(a, layout)
    return sd


def bert_to_jax_params(tensors: Dict[str, torch.Tensor]) -> dict:
    """Inverse of ``bert_from_jax_params``: the flax params tree."""
    params = {}
    for key, t in tensors.items():
        path, layout = flax_path(key)
        a = t.detach().cpu().numpy()
        _set(params, path, np.ascontiguousarray(a.T if layout == "linear"
                                                else a))
    return params


def from_jax_params(params_np, batch_stats_np=None,
                    model=None) -> Dict[str, torch.Tensor]:
    family = _family(model, "bert" if _is_bert_tree(params_np) else
                     "flax_named" if _is_flax_named_tree(params_np)
                     else "vgg")
    if family == "bert":
        return bert_from_jax_params(params_np)
    if family == "flax_named":
        return flax_named_from_jax(params_np, batch_stats_np)
    sd = {}
    for mod, leaves in params_np.items():
        m = _CONV.match(mod)
        if m:
            i = m.group(1)
            sd[f"convs.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(
                    np.transpose(np.asarray(leaves["kernel"]), (3, 2, 0, 1))))
            sd[f"convs.{i}.bias"] = torch.from_numpy(
                np.array(leaves["bias"]))
            continue
        m = _BN.match(mod)
        if m:
            i = m.group(1)
            sd[f"bns.{i}.scale"] = torch.from_numpy(np.array(leaves["scale"]))
            sd[f"bns.{i}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
            continue
        if mod == "Dense_0":
            sd["dense.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(leaves["kernel"]).T))
            sd["dense.bias"] = torch.from_numpy(np.array(leaves["bias"]))
            continue
        raise KeyError(f"unexpected flax module {mod!r}")
    for mod, stats in (batch_stats_np or {}).items():
        i = _BN.match(mod).group(1)
        sd[f"bns.{i}.mean"] = torch.from_numpy(np.array(stats["mean"]))
        sd[f"bns.{i}.var"] = torch.from_numpy(np.array(stats["var"]))
    return sd


def to_jax_params(tensors: Dict[str, torch.Tensor],
                  model=None) -> Tuple[dict, dict]:
    """Inverse of ``from_jax_params``: (params, batch_stats) as nested
    dicts of numpy arrays in the flax layout (``batch_stats`` empty for
    BERT and the PTB LSTM). Keys absent from ``tensors`` are skipped, so a dict of
    gradients maps too."""
    family = _family(model, "bert" if _is_bert_state(tensors) else
                     "flax_named" if _is_flax_named_state(tensors)
                     else "vgg")
    if family == "bert":
        return bert_to_jax_params(tensors), {}
    if family == "flax_named":
        return flax_named_to_jax(tensors)
    params, stats = {}, {}
    for key, t in tensors.items():
        a = t.detach().cpu().numpy()
        parts = key.split(".")
        mod, idx, leaf = parts if len(parts) == 3 else (parts[0], None,
                                                        parts[1])
        if mod == "convs":
            d = params.setdefault(f"Conv_{idx}", {})
            if leaf == "weight":
                d["kernel"] = np.ascontiguousarray(
                    np.transpose(a, (2, 3, 1, 0)))
            else:
                d["bias"] = a
        elif mod == "bns":
            if leaf in ("mean", "var"):
                stats.setdefault(f"BatchNorm_{idx}", {})[leaf] = a
            else:
                params.setdefault(f"BatchNorm_{idx}", {})[leaf] = a
        elif mod == "dense":
            d = params.setdefault("Dense_0", {})
            d["kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(a.T) if leaf == "weight" else a)
        else:
            raise KeyError(f"unexpected state_dict key {key!r}")
    return params, stats


# ---------------------------------------------------------------------------
# the whole train state, as the JAX package's DistTrainState state dict

# SparseState fields the JAX state holds as int32 (the rest are float32)
_INT32_FIELDS = ("step", "boundaries", "last_local_count",
                 "last_global_count")


def _nest(pairs) -> dict:
    """A nested dict from (flax path, leaf) pairs, its keys sorted at
    every level as ``jax.device_get`` leaves a flax tree."""
    tree: dict = {}
    for path, v in pairs:
        _set(tree, path, v)

    def srt(t):
        return ({k: srt(t[k]) for k in sorted(t)} if isinstance(t, dict)
                else t)
    return srt(tree)


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def stat_path(model, key: str) -> str:
    """The flax ``batch_stats`` path of a model buffer (a BatchNorm's
    ``mean`` or ``var``)."""
    fam = _family(model, "vgg")
    if fam == "flax_named":
        return flax_named_path(key)[0]
    if fam == "vgg":
        _, i, leaf = key.split(".")
        return f"BatchNorm_{i}/{leaf}"
    raise KeyError(f"BERT has no batch statistics ({key!r})")


def _flat_tree(trainer, flat: torch.Tensor) -> dict:
    """A params-shaped tree of the flat [n] buffer's segments (the flat
    buffers are in the JAX leaf order and layout)."""
    return _nest((path, flat[s:e].view(shp)) for (path, _, _), shp, s, e in
                 zip(trainer.leaves, trainer.jax_shapes,
                     trainer.offsets[:-1], trainer.offsets[1:]))


def _rows(trainer, t: torch.Tensor, gather: bool) -> torch.Tensor:
    """Every worker's row of a per-worker tensor ([W, ...] -> [P, ...]):
    across processes gathered to rank 0 (a collective); the other ranks
    keep their own rows."""
    if gather and trainer.comm.local_workers < trainer.comm.size:
        got = trainer.comm.gather(t)
        return t if got is None else got[0]
    return t


def train_state_to_jax(trainer, host: bool = True,
                       gather: bool = True) -> dict:
    """The Trainer's whole state as the JAX ``DistTrainState`` state
    dict: ``params`` and ``model_state`` (``{"batch_stats": ...}`` where
    the model has BatchNorm, else ``{}``) in the flax tree and layouts;
    ``opt_state`` as SGD's ``{step, momentum_buf}`` (the momentum in the
    params' tree, or None) or BertAdam's ``{step, m, v}``;
    ``sparse_state`` (one ``SparseState`` field dict, or ``{"0": ...,
    "1": ...}`` with ``num_buckets > 1``) and ``local_momentum`` (None
    without momentum correction) with every worker's row; ``quality``
    the step's quality rings (``{ring, cursor, prev_res_norm,
    prev_sig}`` with every worker's row, per bucket as
    ``sparse_state``) when the taps are on, else None; ``health`` the
    step's ``HealthState`` (``{step, steps_skipped, last_anomaly_step,
    bucket_trips}``, replicated: no worker rows) when it carries the
    anomaly guard or a fault plan, else None.

    ``host`` copies every leaf to a fresh host array (the checkpoint);
    otherwise the leaves are the live tensors, viewed in the flax
    layout. Across processes ``gather`` collects every rank's rows on
    rank 0 (a collective: every rank calls it; rank 0's tree is the
    whole state, the other ranks' hold their own rows); without it each
    rank gives its own rows (enough for a restore template)."""
    from oktopk_tpu_torch.collectives.state import TENSOR_FIELDS
    from oktopk_tpu_torch.obs.metrics_buffer import \
        FIELDS as QUALITY_FIELDS
    from oktopk_tpu_torch.optim import BertAdam
    from oktopk_tpu_torch.resilience.guard import HEALTH_FIELDS
    from oktopk_tpu_torch.train.checkpoint import host_tree

    model = trainer.model
    params = _nest((path, to_jax_layout(p.detach(), layout))
                   for path, p, layout in trainer.leaves)
    stats = _nest((stat_path(model, k), b)
                  for k, b in model.named_buffers())
    opt = trainer.optimizer
    if isinstance(opt, BertAdam):
        opt_state = {"step": opt.step, "m": _flat_tree(trainer, opt.m),
                     "v": _flat_tree(trainer, opt.v)}
    else:
        buf = (None if opt.momentum_buf is None else _nest(
            (path, to_jax_layout(b, layout))
            for (path, _, layout), b in zip(trainer.leaves,
                                            opt.momentum_buf)))
        opt_state = {"step": opt.step, "momentum_buf": buf}
    gs = trainer.grad_step
    sparse = [{f: _rows(trainer, getattr(st, f).to(
        torch.int32 if f in _INT32_FIELDS else torch.float32), gather)
        for f in TENSOR_FIELDS} for st in gs.states]
    moms = (None if gs.momenta is None
            else [_rows(trainer, m, gather) for m in gs.momenta])
    quals = (None if gs.qualities is None
             else [{f: _rows(trainer, getattr(q, f), gather)
                    for f in QUALITY_FIELDS} for q in gs.qualities])
    bucketed = trainer.cfg.num_buckets > 1
    state = {
        "params": params,
        "model_state": {"batch_stats": stats} if stats else {},
        "opt_state": opt_state,
        "sparse_state": ({str(i): s for i, s in enumerate(sparse)}
                         if bucketed else sparse[0]),
        "local_momentum": (None if moms is None else
                           {str(i): m for i, m in enumerate(moms)}
                           if bucketed else moms[0]),
        "health": (None if gs.health is None else
                   {f: getattr(gs.health, f) for f in HEALTH_FIELDS}),
        "quality": (None if quals is None else
                    {str(i): q for i, q in enumerate(quals)}
                    if bucketed else quals[0]),
    }
    return host_tree(state) if host else state


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


@torch.no_grad()
def _copy(dst: torch.Tensor, src, what: str) -> None:
    src = _as_tensor(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: checkpoint shape {tuple(src.shape)} "
                         f"vs the model's {tuple(dst.shape)}")
    if src is not dst:
        dst.copy_(src)


def load_train_state_from_jax(trainer, tree: dict,
                              parts=("params", "model_state", "opt_state",
                                     "sparse_state", "local_momentum",
                                     "quality", "health")
                              ) -> None:
    """Put a JAX ``DistTrainState`` state dict (``train_state_to_jax``'s
    layout, from either package's checkpoint) into the Trainer, in
    place. Each process takes its own workers' rows of the per-worker
    state. A leaf that is a tensor is the live state itself (a restore
    template's default) and is left as it is. ``parts`` names the fields
    to load (``evaluate`` loads the model's alone). The quality rings,
    ring and cursor included, load when the Trainer has the taps on and
    the tree carries them (a file saved without the taps leaves fresh
    rings). The health counters load when the Trainer's step carries
    them and the tree has them, the host mirror of the attempted-step
    clock with them (a restore rewinds it, as JAX's does)."""
    from oktopk_tpu_torch.collectives.state import (TENSOR_FIELDS,
                                                    SparseState)
    from oktopk_tpu_torch.resilience.guard import (HEALTH_FIELDS,
                                                   HealthState)
    from oktopk_tpu_torch.obs.metrics_buffer import \
        FIELDS as QUALITY_FIELDS
    from oktopk_tpu_torch.optim import BertAdam

    model, dev = trainer.model, trainer.device
    if "params" in parts:
        for path, p, layout in trainer.leaves:
            a = _get(tree["params"], path)
            if not isinstance(a, torch.Tensor):
                _copy(p, from_jax_layout(_as_tensor(a), layout),
                      f"params/{path}")
    if "model_state" in parts:
        for k, b in model.named_buffers():
            path = "batch_stats/" + stat_path(model, k)
            _copy(b, _get(tree["model_state"], path), path)
    if "opt_state" in parts:
        _load_opt(trainer, tree["opt_state"], BertAdam)
    first, W, P = (trainer.comm.first_worker, trainer.comm.local_workers,
                   trainer.comm.size)

    def rows(a, what):
        a = _as_tensor(a)
        if a.shape[0] != P:
            raise ValueError(f"{what}: the checkpoint has {a.shape[0]} "
                             f"workers, the trainer {P}")
        return a[first:first + W].to(dev)

    gs = trainer.grad_step
    bucketed = trainer.cfg.num_buckets > 1
    if "sparse_state" in parts:
        ss = tree["sparse_state"]
        for b, st in enumerate(gs.states):
            d = ss[str(b)] if bucketed else ss
            if isinstance(d["step"], torch.Tensor):
                continue
            kw = {f: rows(d[f], f"sparse_state/{f}").to(
                getattr(st, f).dtype) for f in TENSOR_FIELDS}
            if kw["residual"].shape != st.residual.shape:
                raise ValueError("sparse_state/residual: checkpoint "
                                 f"{tuple(kw['residual'].shape)} vs "
                                 f"{tuple(st.residual.shape)}")
            gs.states[b] = SparseState(
                **kw, host_step=int(kw["step"].reshape(-1)[0]))
    if "local_momentum" in parts and gs.momenta is not None:
        lm = tree["local_momentum"]
        for b in range(len(gs.momenta)):
            a = lm[str(b)] if bucketed else lm
            if not isinstance(a, torch.Tensor):
                _copy(gs.momenta[b], rows(a, "local_momentum"),
                      "local_momentum")
    ht = tree.get("health")
    if ("health" in parts and gs.health is not None and ht is not None
            and not isinstance(ht["step"], torch.Tensor)):
        kw = {f: _as_tensor(ht[f]).to(device=dev, dtype=torch.int32)
              for f in HEALTH_FIELDS}
        if kw["bucket_trips"].shape != gs.health.bucket_trips.shape:
            raise ValueError(
                f"health/bucket_trips: checkpoint "
                f"{tuple(kw['bucket_trips'].shape)} vs "
                f"{tuple(gs.health.bucket_trips.shape)}")
        gs.health = HealthState(**{f: kw[f].reshape(
            getattr(gs.health, f).shape) for f in HEALTH_FIELDS},
            host_step=int(kw["step"]))
    qt = tree.get("quality")
    if "quality" in parts and gs.qualities is not None and qt is not None:
        for b, q in enumerate(gs.qualities):
            d = qt[str(b)] if bucketed else qt
            for f in QUALITY_FIELDS:
                if not isinstance(d[f], torch.Tensor):
                    _copy(getattr(q, f), rows(d[f], f"quality/{f}").to(
                        getattr(q, f).dtype), f"quality/{f}")


def _load_opt(trainer, opt_state: dict, bert_adam_cls) -> None:
    opt = trainer.optimizer
    if isinstance(opt, bert_adam_cls):
        if not isinstance(opt_state["step"], torch.Tensor):
            opt.step = _as_tensor(opt_state["step"]).to(
                device=trainer.device, dtype=torch.int32).reshape(())
        for name in ("m", "v"):
            flat = getattr(opt, name)
            for (path, _, _), shp, s, e in zip(
                    trainer.leaves, trainer.jax_shapes,
                    trainer.offsets[:-1], trainer.offsets[1:]):
                _copy(flat[s:e].view(shp), _get(opt_state[name], path),
                      f"opt_state/{name}/{path}")
        return
    if not isinstance(opt_state["step"], torch.Tensor):
        opt.step = _as_tensor(opt_state["step"]).to(
            device=trainer.device, dtype=torch.int32).reshape(())
    if opt.momentum_buf is not None:
        for (path, _, layout), buf in zip(trainer.leaves, opt.momentum_buf):
            a = _get(opt_state["momentum_buf"], path)
            _copy(buf, from_jax_layout(_as_tensor(a), layout),
                  f"opt_state/momentum_buf/{path}")


# ---- the staged BERT of the pipeline (models/bert_staged.py) -------------

def _stack_tensor(a, layout: str) -> torch.Tensor:
    """A [S, ...] JAX leaf as the torch layout of each stage's row."""
    a = np.asarray(a)
    if layout == "linear":
        a = np.swapaxes(a, -1, -2)
    return torch.from_numpy(np.array(a, np.float32, copy=True, order="C"))


def staged_from_jax(stage_stack_np, shared_np
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """The JAX ``StagedBertPretrain.split`` trees (``stage_stack``: leaves
    [S, ...] under ``sub_j``; ``shared``) -> the port's (stage_stack,
    shared), the layout of ``models.bert_staged.StagedBertPretrain.
    split``."""
    stage = {}
    for path, a in _walk(stage_stack_np):
        key, layout = torch_key(path)
        stage[key] = _stack_tensor(a, layout)
    shared = {}
    for path, a in _walk(shared_np):
        key, layout = torch_key(path)
        shared[key] = _tensor(a, layout)
    return stage, shared


def staged_to_jax(stage_stack: Dict[str, torch.Tensor],
                  shared: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """Inverse of ``staged_from_jax``: the JAX (stage_stack, shared)
    trees as numpy arrays."""
    stage, sh = {}, {}
    for key, t in stage_stack.items():
        path, layout = flax_path(key)
        a = t.detach().cpu().numpy()
        _set(stage, path, np.ascontiguousarray(
            np.swapaxes(a, -1, -2) if layout == "linear" else a))
    for key, t in shared.items():
        path, layout = flax_path(key)
        a = t.detach().cpu().numpy()
        _set(sh, path, np.ascontiguousarray(a.T if layout == "linear"
                                            else a))
    return _nest(_walk(stage)), _nest(_walk(sh))


def _bucket_tree(bucket, flat: torch.Tensor) -> dict:
    """A bucket's flat [n] buffer (JAX layout) as its JAX tree of numpy
    arrays."""
    return _nest(("/".join(path), x.numpy().copy()) for path, x in
                 zip(bucket.paths, bucket.jax_views(flat.detach().cpu())))


def _opt_to_jax(opt, bucket) -> dict:
    return {"step": np.asarray(opt.step.cpu().numpy()),
            "m": _bucket_tree(bucket, opt.m),
            "v": _bucket_tree(bucket, opt.v)}


def pipeline_opt_to_jax(staged, opt_states) -> Tuple[dict, dict]:
    """``init_pipeline_opt_state``'s BertAdams as the JAX package's outer
    layout: (the stage states stacked [S] — ``step`` [S], ``m`` and ``v``
    trees with leaves [S, ...] — and the shared ``{step, m, v}``), numpy.
    ``staged`` must hold every stage (the stacked grid)."""
    from oktopk_tpu_torch.parallel.bert_pipeline import Bucket
    stage_opts, shared_opt = opt_states
    rows = [_opt_to_jax(o, Bucket(staged.stage_leaves(w)))
            for w, o in enumerate(stage_opts)]
    stage = {"step": np.stack([r["step"] for r in rows]),
             "m": _nest((p, np.stack([_get(r["m"], p) for r in rows]))
                        for p, _ in _walk(rows[0]["m"])),
             "v": _nest((p, np.stack([_get(r["v"], p) for r in rows]))
                        for p, _ in _walk(rows[0]["v"]))}
    return stage, _opt_to_jax(shared_opt, Bucket(staged.shared_leaves()))


@torch.no_grad()
def pipeline_opt_from_jax(staged, opt_states, stage_tree: dict,
                          shared_tree: dict) -> None:
    """Load JAX's outer-layout BertAdam states (``pipeline_opt_to_jax``'s
    layout) into ``opt_states``, each held stage its own row."""
    from oktopk_tpu_torch.parallel.bert_pipeline import Bucket
    from oktopk_tpu_torch.utils.flatten import flatten_tree

    def load(opt, bucket, tree, row=None):
        def flat(sub):
            t = {p: _as_tensor(a if row is None else np.asarray(a)[row])
                 for p, a in _walk(sub)}
            return flatten_tree(_nest(t.items()))[0]
        step = np.asarray(tree["step"])
        opt.step = torch.tensor(int(step if row is None else step[row]),
                                dtype=torch.int32, device=opt.m.device)
        opt.m = flat(tree["m"]).to(opt.m.device)
        opt.v = flat(tree["v"]).to(opt.v.device)
        if opt.m.numel() != bucket.n:
            raise ValueError(f"optimizer state of {opt.m.numel()} for a "
                             f"bucket of {bucket.n}")

    stage_opts, shared_opt = opt_states
    for w, s in enumerate(staged.stage_ids):
        load(stage_opts[w], Bucket(staged.stage_leaves(w)), stage_tree, s)
    load(shared_opt, Bucket(staged.shared_leaves()), shared_tree)
