#!/usr/bin/env python3
"""The bfloat16 yardstick of ``tests/test_torch_bf16.py`` with the
port's model on any device: how far the port's bfloat16 lies from
flax's bfloat16 (``d_port``) against how far flax's bfloat16 lies from
its float32 (``d_ref``), on the logits and on the float32 flat
parameter gradient of a weighted sum of the logits, each over the
largest |value| of flax's float32.

The flax side comes from files, so this script needs no JAX: each
``<case>.npz`` under REFDIR holds one family's inputs, output weights,
flax parameters and batch statistics and flax's float32 and bfloat16
logits and gradient, written where the JAX package is installed by::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests');
        import test_torch_bf16 as t; t.write_references('REFDIR')"

Run from the repository root::

    python3 scripts/bf16_card_yardstick.py REFDIR [--device cuda] \
        [--ptb-cell torch_lstm]

It prints one JSON line per case, with the leaf whose gradient lies
farthest in units of its own d_ref. On the card the products are cuDNN's
and cuBLAS's (TF32 off, no bfloat16 split-K reduction, deterministic
cuDNN), DeepSpeech's LSTM cuDNN's bfloat16 RNN.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def unflatten(flat: dict) -> dict:
    """{"a/b/c": array} -> nested dicts."""
    tree = {}
    for path, a in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def load_reference(path: str) -> dict:
    """A ``write_references`` file as the dict ``port_distance`` takes."""
    z = np.load(path)
    ref = json.loads(str(z["meta"]))
    ref["xs"] = [z[f"x{i}"] for i in range(ref["n_xs"])]
    ref["ws"] = [z[f"w{i}"] for i in range(ref["n_ws"])]
    ref["params"] = unflatten({k[2:]: z[k] for k in z.files
                               if k.startswith("p:")})
    ref["stats"] = unflatten({k[2:]: z[k] for k in z.files
                              if k.startswith("s:")})
    for k in ("o32", "g32", "o16", "g16"):
        ref[k] = z[k]
    return ref


def port_distance(ref: dict, device="cpu") -> dict:
    """{"logits": (d_ref, d_port), "grad": (d_ref, d_port), "leaves":
    {path: (d_ref, d_port)}} of the port's bfloat16 model on ``device``
    against the flax reference ``ref``; a leaf's distances are over the
    largest |value| of that leaf's float32 gradient. ``ref["train"]``
    False runs BatchNorm on its running statistics."""
    import torch
    from oktopk_tpu_torch.convert import from_jax_params
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.models.layout import to_jax_layout

    m = create_model(ref["dnn"], dtype=torch.bfloat16, **ref["kw"])
    m.load_state_dict(from_jax_params(ref["params"], ref["stats"] or None,
                                      model=m))
    m.to(device)
    out = m(*[torch.from_numpy(a).to(device) for a in ref["xs"]],
            train=ref.get("train", True))
    out = out if isinstance(out, tuple) else (out,)
    if any(o.dtype != torch.float32 for o in out):
        raise AssertionError(f"{ref['dnn']}: logits not float32")
    sum((a * torch.from_numpy(w).to(device)).sum()
        for a, w in zip(out, ref["ws"])).backward()
    op = np.concatenate([a.detach().cpu().numpy().reshape(-1) for a in out])
    gp = np.concatenate([to_jax_layout(p.grad, lay).cpu().reshape(-1)
                         .numpy() for _, p, lay in m.jax_leaves()])
    o32, o16, g32, g16 = ref["o32"], ref["o16"], ref["g32"], ref["g16"]

    def d(a32, a16, ap):
        s = np.abs(a32).max()
        return (float(np.abs(a16 - a32).max() / s),
                float(np.abs(ap - a16).max() / s))
    leaves, at = {}, 0
    for path, p, _ in m.jax_leaves():
        n = p.numel()
        if np.any(g32[at:at + n]):
            leaves[path] = d(*(a[at:at + n] for a in (g32, g16, gp)))
        at += n
    return {"logits": d(o32, o16, op), "grad": d(g32, g16, gp),
            "leaves": leaves}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("refdir")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ptb-cell", choices=("written_out", "torch_lstm"),
                   default="written_out",
                   help="the PTB model's bfloat16 LSTM: flax's cell written "
                   "out (the model's) or torch.lstm (cuDNN on the card), "
                   "to measure the choice")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if args.ptb_cell == "torch_lstm":
        from oktopk_tpu_torch.models import lstm, rnn
        lstm.lstm_written_out = lambda x, cell: rnn.lstm(x, (cell,))
    if args.device.startswith("cuda"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        matmul = torch.backends.cuda.matmul
        matmul.allow_tf32 = False
        matmul.allow_bf16_reduced_precision_reduction = False
    files = sorted(glob.glob(os.path.join(args.refdir, "*.npz")))
    if not files:
        print(f"no reference files under {args.refdir}", file=sys.stderr)
        return 2
    for path in files:
        case = os.path.basename(path)[:-4]
        d = port_distance(load_reference(path), args.device)
        print(json.dumps({"case": case, "device": args.device,
                          "ptb_cell": args.ptb_cell,
                          **{k: {"d_ref": d[k][0], "d_port": d[k][1],
                                 "ratio": d[k][1] / d[k][0]}
                             for k in ("logits", "grad")},
                          "worst_leaf": max(
                              ((v[1] / v[0], k) for k, v in
                               d["leaves"].items() if v[0] > 0))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
