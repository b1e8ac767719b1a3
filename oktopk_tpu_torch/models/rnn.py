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
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence

import torch
import torch.nn as nn

GATES = ("i", "f", "g", "o")


class Kernel(nn.Module):
    """flax ``DenseParams``: a kernel and, for the recurrent ones, a
    bias."""

    def __init__(self, in_features: int, features: int, bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, in_features))
        if bias:
            self.bias = nn.Parameter(torch.zeros(features))


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell(hidden)``: submodules ``ii`` .. ``io``
    and ``hi`` .. ``ho`` as in the flax tree."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module("i" + g, Kernel(in_features, hidden, False))
        for g in GATES:
            self.add_module("h" + g, Kernel(hidden, hidden, True))

    def weights(self):
        """[w_ih, w_hh, b_ih, b_hh] as ``torch.lstm`` takes them."""
        w_ih = torch.cat([self.get_submodule("i" + g).kernel
                          for g in GATES])
        w_hh = torch.cat([self.get_submodule("h" + g).kernel
                          for g in GATES])
        b_hh = torch.cat([self.get_submodule("h" + g).bias for g in GATES])
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
    """One LSTM layer over ``x`` [B, T, in] from a zero carry: ``cells``
    is (forward,) or (forward, backward); the two directions' outputs
    are summed (``nn.Bidirectional(merge_fn=a + b)``). Returns
    [B, T, H]."""
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
