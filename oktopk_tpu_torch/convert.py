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

from oktopk_tpu_torch.models.bert import (BertForPreTraining, flax_path,
                                          torch_key)
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
    if isinstance(model, BertForPreTraining):
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
