"""LSTM layers: the counterpart of flax's ``OptimizedLSTMCell`` under
``nn.RNN`` and ``nn.Bidirectional``, as ``oktopk_tpu/models/deepspeech.py``
and ``models/lstm.py`` use them.

A cell keeps flax's eight parameters, one leaf each, named as in flax:
the input kernels ``ii``, ``if``, ``ig``, ``io`` [H, in] without bias
and the recurrent kernels ``hi``, ``hf``, ``hg``, ``ho`` [H, H] with a
bias [H] each (torch's [out, in] layout, the flax kernel transposed;
``models/layout.py``). They are not fused into torch's ``weight_ih``
[4H, in]: the flat gradient buffer, its buckets and regions follow the
JAX leaf order (``hf, hg, hi, ho, if, ig, ii, io``), and ``nn.LSTM``'s
second bias (``bias_ih``) would be a trainable leaf flax does not have.

The forward concatenates them in gate order i, f, g, o (flax's and
torch's) into ``w_ih`` [4H, in] and ``w_hh`` [4H, H], with a zero
``b_ih`` (not a parameter) and the h-biases as ``b_hh``, and calls
``torch.lstm``, the function ``nn.LSTM.forward`` calls: cuDNN's RNN on
the card, PyTorch's own loop on the CPU. The carry starts at zeros, and
no sequence lengths are passed: flax's reverse direction
(``reverse=True, keep_order=True``, no ``seq_lengths``) reverses the
whole padded time axis, as a torch bidirectional layer does.

In bfloat16 (flax's ``OptimizedLSTMCell(dtype=bf16)``) the gate products
take the input, ``h`` and the parameters cast to bfloat16, and the gate
arithmetic runs in bfloat16. The carry keeps the dtype it starts in:
flax's ``nn.RNN`` starts DeepSpeech's from ``initialize_carry``, in the
float32 ``param_dtype``, so its ``c`` and ``h`` stay float32 through the
mixed ``f * c + i * g``; the PTB model starts from zeros in its compute
dtype, so its carry is bfloat16. ``torch.lstm`` (cuDNN on the card)
keeps its carry in the data dtype. ``lstm_written_out`` is flax's cell
step by step, for either carry. The models choose by what was measured
against flax (ROADMAP.md, H22): the PTB model runs the written-out cell
(its logits come closer to flax's than ``torch.lstm``'s fused step, on
the CPU and on the card); DeepSpeech runs ``torch.lstm`` with a
bfloat16 carry, which is as close to flax as the written-out float32
carry is at a full utterance's length, at a fraction of its launches.
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from oktopk_tpu_torch.models.layers import Mixed, promote

GATES = ("i", "f", "g", "o")


class Kernel(nn.Module):
    """flax ``DenseParams``: a kernel and, for the recurrent ones, a
    bias."""

    def __init__(self, in_features: int, features: int, bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.zeros(features))


class LSTMCell(Mixed, nn.Module):
    """flax ``OptimizedLSTMCell(hidden)``: submodules ``ii`` .. ``io``
    and ``hi`` .. ``ho`` as in the flax tree."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module("i" + g, Kernel(in_features, hidden, False))
        for g in GATES:
            self.add_module("h" + g, Kernel(hidden, hidden, True))

    def master_weights(self):
        """[w_ih, w_hh, b_hh], the gates' kernels and biases concatenated,
        in the parameters' float32."""
        return [torch.cat([self.get_submodule(k + g).get_parameter(leaf)
                           for g in GATES])
                for k, leaf in (("i", "kernel"), ("h", "kernel"),
                                ("h", "bias"))]

    def weights(self):
        """[w_ih, w_hh, b_ih, b_hh] as ``torch.lstm`` takes them, in the
        compute dtype (flax casts the concatenated kernels and bias)."""
        w_ih, w_hh, b_hh = promote(self.compute_dtype,
                                   *self.master_weights())
        return [w_ih, w_hh, torch.zeros_like(b_hh), b_hh]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun-normal input kernels, orthogonal
        recurrent kernels, zero biases (drawn from ``generator``; not
        JAX's draws)."""
        for g in GATES:
            k = self.get_submodule("i" + g).kernel
            k.copy_(torch.randn(k.shape, generator=generator)
                    / math.sqrt(k.shape[1]))
            h = self.get_submodule("h" + g)
            nn.init.orthogonal_(h.kernel, generator=generator)
            h.bias.zero_()


def lstm(x: torch.Tensor, cells: Sequence[LSTMCell]) -> torch.Tensor:
    """One LSTM layer over ``x`` [B, T, in] from a zero carry through
    ``torch.lstm``: ``cells`` is (forward,) or (forward, backward); the
    two directions' outputs are summed (``nn.Bidirectional(merge_fn=a +
    b)``). In a compute dtype ``x`` is cast to it. Returns [B, T, H]."""
    (x,) = promote(cells[0].compute_dtype, x)
    hidden = cells[0].hidden
    dirs = len(cells)
    h0 = x.new_zeros((dirs, x.shape[0], hidden))
    weights = [w for c in cells for w in c.weights()]
    with warnings.catch_warnings():
        # cuDNN copies the concatenated weights into its own flat buffer
        # on each call and says so; the copy is the design (one leaf per
        # flax kernel)
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, _, _ = torch.lstm(x, (h0, h0), weights, True, 1, 0.0,
                               torch.is_grad_enabled(), dirs == 2, True)
    if dirs == 1:
        return out
    return out[..., :hidden] + out[..., hidden:]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """flax's ``sigmoid`` (``lax.logistic``) as XLA's CPU backend expands
    it: ``1 / (1 + exp(-x))``, each op rounded to the operand's dtype."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return one / (one + torch.exp(-x))


def lstm_written_out(x: torch.Tensor, cell: LSTMCell, carry_dtype=None,
                     reverse: bool = False) -> torch.Tensor:
    """One direction of flax's ``nn.RNN(OptimizedLSTMCell)`` over ``x``
    [B, T, in] (already in the compute dtype) from a zero carry of
    ``carry_dtype`` (``x``'s by default), one time step at a time, as
    flax's cell computes it: ``dense_h = h @ W_hh + b`` and ``dense_i =
    x @ W_ih`` in the compute dtype (the input products of every step in
    one call), the gates from ``dense_h + dense_i``, ``c = f * c + i *
    g`` and ``h = o * tanh(c)`` in the dtypes JAX promotes them to (a
    float32 carry stays float32). The recurrent kernel and bias are cast
    at every step, as flax's scan casts them: the steps' gradients then
    reach the float32 parameters one by one and add up in float32 (cast
    once, they would add up in bfloat16). ``reverse`` runs the time axis backwards and keeps the
    output in the input's order (``reverse=True, keep_order=True``).
    Returns [B, T, H] of the carry's dtype."""
    w_ih, w_hh32, b_hh32 = cell.master_weights()
    (w_ih,) = promote(x.dtype, w_ih)
    dense_i = F.linear(x, w_ih)                       # [B, T, 4H]
    B, T = x.shape[0], x.shape[1]
    c = torch.zeros((B, cell.hidden), dtype=carry_dtype or x.dtype,
                    device=x.device)
    h = c
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        w_hh, b_hh = promote(x.dtype, w_hh32, b_hh32)
        dense_h = F.linear(h.to(x.dtype), w_hh) + b_hh
        i, f, g, o = (dense_h + dense_i[:, t]).chunk(4, -1)
        i, f, g, o = sigmoid(i), sigmoid(f), torch.tanh(g), sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        out[t] = h
    return torch.stack(out, 1)
