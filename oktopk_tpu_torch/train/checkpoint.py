"""Checkpoint and resume, the sparse-algorithm state included, in the JAX
package's file format.

Counterpart of ``oktopk_tpu/train/checkpoint.py``. A checkpoint is the
JAX package's file: ``<dir>/<prefix>-<step>.msgpack`` holding flax's
msgpack encoding (``train/msgpack.py``) of ``{"step", "state",
"extra"?}``, where ``state`` is the ``DistTrainState`` state dict in
flax names and layouts (``convert.train_state_to_jax``): ``params``,
``model_state``, ``opt_state``, ``sparse_state`` with its leading worker
axis, ``local_momentum``, ``health`` and ``quality``. A file written by
either package resumes in the other. Each save publishes atomically and
writes the sidecar manifest (``train/durable.py``); a restore verifies
by default and walks newest -> oldest past corrupt files.

State trees may hold torch tensors (on any device) or numpy arrays:
``host_tree`` copies every tensor into a fresh host array, once, before
anything is written, so a save holds the state at the moment of the call
even though the trainer updates its tensors in place. Reads go through a
small cache keyed on (mtime, size), so a restore and ``load_extra`` on
one file decode it once.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from oktopk_tpu_torch.train import durable, msgpack

_log = logging.getLogger("oktopk_tpu_torch")

# Above this fraction of mismatched leaves the checkpoint is almost
# certainly for a different --model/config, and restore raises instead
# of silently training a mostly-fresh model (force=True downgrades the
# raise back to the warning).
MERGE_ESCALATION_FRAC = 0.5


def _host(t: torch.Tensor) -> np.ndarray:
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    out.copy_(t.detach())
    return out.numpy()


def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor copied into a fresh contiguous host
    array (numpy arrays and other leaves are taken as they are)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _host(tree)
    return tree


def checkpoint_path(ckpt_dir: str, step: int, prefix: str = "ckpt") -> str:
    """Where :func:`save_checkpoint` writes the checkpoint of ``step``."""
    return os.path.join(ckpt_dir, f"{prefix}-{int(step)}.msgpack")


def save_checkpoint(ckpt_dir: str, state: Any, step: int,
                    prefix: str = "ckpt",
                    extra: Optional[dict] = None,
                    qualified: bool = True) -> str:
    """Serialise the train state to ``<ckpt_dir>/<prefix>-<step>.msgpack``.

    ``extra`` is an optional side payload of plain scalars and lists,
    stored JSON-encoded under its own key and read back with
    :func:`load_extra`. The data file is published atomically, then its
    manifest; ``qualified=False`` marks a checkpoint that retention may
    collect first."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step, prefix)
    payload = {"step": int(step), "state": host_tree(state)}
    if extra:
        payload["extra"] = json.dumps(extra)
    data = msgpack.encode(payload)
    durable.atomic_write_bytes(path, data)
    durable.write_manifest(path, step, data, qualified=qualified)
    return path


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest checkpoint file by step, unverified (resume paths use
    ``durable.latest_verified_checkpoint``)."""
    entries = durable.scan_checkpoints(ckpt_dir, prefix)
    return entries[0][1] if entries else None


# ---------------------------------------------------------------------------
# shared raw reader (one decode per file for restore + load_extra)

_READ_CACHE: Dict[str, Tuple[Tuple[int, int], Any]] = {}
_READ_CACHE_MAX = 4
_READ_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    """Drop the decoded payloads the reader keeps."""
    with _READ_CACHE_LOCK:
        _READ_CACHE.clear()


def read_payload(path: str, use_cache: bool = True,
                 data: Optional[bytearray] = None) -> Any:
    """The decoded payload of ``path`` ({"step", "state", "extra"?});
    ``data`` is the file's bytes when the caller has read them already
    (``durable.verified_restore``). Callers must not mutate the returned
    tree."""
    apath = os.path.abspath(path)
    st = os.stat(apath)
    key = (st.st_mtime_ns, st.st_size)
    if use_cache:
        with _READ_CACHE_LOCK:
            hit = _READ_CACHE.get(apath)
            if hit is not None and hit[0] == key:
                return hit[1]
    raw = msgpack.decode(durable.read_file(apath) if data is None
                         else data)
    if use_cache:
        with _READ_CACHE_LOCK:
            if len(_READ_CACHE) >= _READ_CACHE_MAX and apath not in _READ_CACHE:
                _READ_CACHE.pop(next(iter(_READ_CACHE)))
            _READ_CACHE[apath] = (key, raw)
    return raw


def _merge_missing(template, loaded, path="", defaulted=None, dropped=None,
                   counts=None):
    """Overlay ``loaded`` on ``template``, keeping template values for keys
    the checkpoint lacks, and never letting a ``None`` in the checkpoint
    replace a non-``None`` template leaf; ``defaulted``/``dropped``
    collect the key paths that kept template values / were ignored, and
    ``counts`` the same in leaves (``oktopk_tpu/train/checkpoint.py``'s
    rule, line for line)."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            return loaded
        for k in loaded:
            if k not in template:
                if dropped is not None:
                    dropped.append(f"{path}{k}")
                if counts is not None:
                    counts["dropped"] += _num_leaves(loaded[k])
        out = {}
        for k, v in template.items():
            if k in loaded:
                lv = loaded[k]
                if lv is None and v is not None:
                    if defaulted is not None:
                        defaulted.append(f"{path}{k}")
                    if counts is not None:
                        counts["defaulted"] += _num_leaves(v)
                    out[k] = v
                else:
                    out[k] = _merge_missing(v, lv, f"{path}{k}/",
                                            defaulted, dropped, counts)
            else:
                if defaulted is not None:
                    defaulted.append(f"{path}{k}")
                if counts is not None:
                    counts["defaulted"] += _num_leaves(v)
                out[k] = v
        return out
    return loaded


def _num_leaves(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_num_leaves(v) for v in tree.values())
    return 1


def apply_template(raw: Any, state_template: Any, path: str = "<payload>",
                   force: bool = False) -> Tuple[Any, int]:
    """Merge a decoded payload into the template's structure; returns
    ``(state, step)``. The template's leaves (tensors, arrays or None)
    only stand in where the file lacks a field. More than
    ``MERGE_ESCALATION_FRAC`` of the leaves defaulted or dropped raises
    ``ValueError`` (``force`` downgrades it to the warning)."""
    raw = dict(raw)              # never mutate read_payload's cached tree
    raw.pop("extra", None)       # side payload (load_extra), not train state
    wrapped = {"step": 0, "state": state_template}
    defaulted, dropped = [], []
    counts = {"defaulted": 0, "dropped": 0}
    merged = _merge_missing(wrapped, raw, defaulted=defaulted,
                            dropped=dropped, counts=counts)
    if defaulted or dropped:
        total = _num_leaves(wrapped) + counts["dropped"]
        frac = (counts["defaulted"] + counts["dropped"]) / max(1, total)
        msg = (f"checkpoint {path} does not fully match the current "
               f"state: {len(defaulted)} field(s) kept fresh template "
               f"values {defaulted[:8]}; {len(dropped)} checkpoint "
               f"field(s) ignored {dropped[:8]} "
               f"({frac:.0%} of leaves mismatched)")
        if frac > MERGE_ESCALATION_FRAC and not force:
            raise ValueError(
                msg + f" — above the {MERGE_ESCALATION_FRAC:.0%} "
                "threshold, this checkpoint is almost certainly for a "
                "different --model/config; pass --ckpt-force to restore "
                "anyway")
        _log.warning("%s", msg)
    return merged["state"], int(merged["step"])


def _leaves_with_path(tree: Any, prefix: str = ""):
    """(path, leaf) in ``jax.tree.flatten`` order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}['{k}']")
    else:
        yield prefix, tree


def _restore_like(template: Any, loaded: Any, path: str = "") -> Any:
    """``loaded`` in ``template``'s structure (flax ``from_state_dict``:
    a key the template has and the file lacks raises, extra keys are
    ignored)."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"checkpoint has a leaf at {path or '/'} where "
                             "the model has a subtree")
        missing = [k for k in template if k not in loaded]
        if missing:
            raise ValueError(f"checkpoint lacks {path}/{missing[0]} "
                             f"({len(missing)} field(s) missing)")
        return {k: _restore_like(v, loaded[k], f"{path}/{k}")
                for k, v in template.items()}
    return loaded


def _resolve(ckpt_dir_or_file: str, prefix: str) -> Optional[str]:
    if os.path.isdir(ckpt_dir_or_file):
        return durable.latest_verified_checkpoint(ckpt_dir_or_file, prefix)
    return ckpt_dir_or_file


def load_encoder_params(ckpt_dir_or_file: str, params: Any,
                        subtree: str = "bert",
                        prefix: str = "ckpt") -> Any:
    """Warm-start fine-tuning: the flax ``params`` tree (nested dicts)
    with its ``subtree`` replaced by the checkpoint's, the task head
    untouched. Every leaf is shape-checked against the template, so a
    bert_large checkpoint grafted into a bert_base model fails here."""
    path = _resolve(ckpt_dir_or_file, prefix)
    if path is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir_or_file}")
    raw = read_payload(path)
    loaded = raw.get("state", raw)
    loaded = loaded.get("params", loaded)
    if subtree not in loaded:
        raise KeyError(
            f"checkpoint {path} has no '{subtree}' params subtree "
            f"(top-level keys: {sorted(loaded)[:8]})")
    if subtree not in params:
        raise KeyError(f"model params have no '{subtree}' subtree")
    encoder = _restore_like(params[subtree], loaded[subtree])
    mismatches = []
    for (path_t, t), (_, l) in zip(_leaves_with_path(params[subtree]),
                                   _leaves_with_path(encoder)):
        if tuple(np.shape(t)) != tuple(np.shape(l)):
            mismatches.append(
                f"{path_t}: template {tuple(np.shape(t))} vs checkpoint "
                f"{tuple(np.shape(l))}")
    if mismatches:
        raise ValueError(
            f"checkpoint {path} encoder shapes do not match the model "
            f"(wrong --model for this checkpoint?): " + "; ".join(
                mismatches[:6]))
    out = dict(params)
    out[subtree] = encoder
    return out


def load_extra(ckpt_dir_or_file: str, prefix: str = "ckpt"
               ) -> Optional[dict]:
    """The ``extra`` side payload of a checkpoint (None when it has
    none)."""
    path = _resolve(ckpt_dir_or_file, prefix)
    if path is None:
        return None
    extra = read_payload(path).get("extra")
    if extra is None:
        return None
    if isinstance(extra, bytes):
        extra = extra.decode()
    return json.loads(extra)


def restore_checkpoint(ckpt_dir_or_file: str, state_template: Any,
                       prefix: str = "ckpt", verify: bool = True,
                       bus=None, journal=None, step: int = 0,
                       force: bool = False) -> Tuple[Any, int]:
    """Restore into the template's structure; returns (state, step).

    Fields the file lacks keep the template's values; a mismatch beyond
    ``MERGE_ESCALATION_FRAC`` of leaves raises (``force`` overrides).
    With ``verify=True`` (the default) candidates are checked against
    their manifests and walked newest -> oldest past corrupt files
    (``durable.verified_restore``); ``verify=False`` restores exactly
    the named file."""
    if verify:
        state, ckpt_step, _, _, _ = durable.verified_restore(
            ckpt_dir_or_file, state_template, prefix=prefix, bus=bus,
            journal=journal, step=step, force=force)
        return state, ckpt_step
    path = ckpt_dir_or_file
    if os.path.isdir(path):
        path = latest_checkpoint(path, prefix)
        if path is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir_or_file}")
    return apply_template(read_payload(path), state_template, path=path,
                          force=force)
