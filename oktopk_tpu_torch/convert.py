"""Map the flax VGG variables onto the port's ``state_dict`` and back.

``from_jax_params`` takes the flax ``params`` and ``batch_stats`` trees as
nested dicts of numpy arrays and returns a ``state_dict`` for
``models.vgg.VGG``: conv kernels HWIO -> OIHW, the Dense kernel
[in, out] -> the Linear weight [out, in], BatchNorm ``scale``/``bias`` and
the ``mean``/``var`` statistics by name. ``to_jax_params`` is its inverse
(it also maps gradients, for the flat-gradient comparison).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_CONV = re.compile(r"^Conv_(\d+)$")
_BN = re.compile(r"^BatchNorm_(\d+)$")


def from_jax_params(params_np, batch_stats_np=None) -> Dict[str, torch.Tensor]:
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


def to_jax_params(tensors: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """Inverse of ``from_jax_params``: (params, batch_stats) as nested
    dicts of numpy arrays in the flax layout. Keys absent from
    ``tensors`` are skipped, so a dict of gradients maps too."""
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
