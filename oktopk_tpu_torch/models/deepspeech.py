"""DeepSpeech-style CTC speech model: a 2-conv spectrogram frontend
(41x11 stride (2, 2), 21x11 stride (2, 1), each with BatchNorm and
hardtanh), a stack of bidirectional LSTM layers whose two directions are
summed, sequence-wise BatchNorm before every layer but the first, a
final BatchNorm and a bias-free head to 29 classes.

Counterpart of ``oktopk_tpu/models/deepspeech.py``, module for module:
submodules carry the flax names (``Conv_0``, ``BatchNorm_2``,
``BatchRNN_1/BatchNorm_0``, ``BatchRNN_i/OptimizedLSTMCell_0`` the
forward direction and ``_1`` the backward, ``Dense_0``), so
``convert.py`` maps the flax tree by name (``models/layout.py``) and
``jax_leaves`` sorts them into the JAX leaf order.

The input is the JAX model's ``[B, freq, time, 1]``; it becomes NCHW
(``[B, 1, freq, time]``) inside. Before the LSTM stack the JAX model
transposes ``[B, F', T', C]`` to ``[B, T', F', C]`` and flattens with C
fastest (41 x 32 = 1312 features); from NCHW ``[B, C, F', T']`` that is
``permute(0, 3, 2, 1)``. The frontend's BatchNorms reduce over NCHW's
(0, 2, 3), the sequence-wise ones over [B, T, F]'s (0, 1). Running
statistics are updated only where the caller asks (worker 0, H7).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from oktopk_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                            set_compute_dtype)
from oktopk_tpu_torch.models.layout import FlaxNamedModule
from oktopk_tpu_torch.models.rnn import LSTMCell, lstm

# Net time-axis downsampling of the conv frontend: T -> ceil(T / 2)
# (the first conv strides time by 2, the second by 1).
CONV_TIME_STRIDE = 2


def hardtanh(x, lo: float = 0.0, hi: float = 20.0):
    return torch.clamp(x, lo, hi)


class BatchRNN(nn.Module):
    """Sequence-wise BatchNorm (unless ``batch_norm=False``), then a
    bidirectional LSTM with summed directions."""

    def __init__(self, in_features: int, hidden: int,
                 batch_norm: bool = True):
        super().__init__()
        if batch_norm:
            self.BatchNorm_0 = BatchNorm(in_features, axes=(0, 1))
        self.batch_norm = batch_norm
        self.OptimizedLSTMCell_0 = LSTMCell(in_features, hidden)
        self.OptimizedLSTMCell_1 = LSTMCell(in_features, hidden)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if self.batch_norm:
            x = self.BatchNorm_0(x, train, update_stats)
        return lstm(x, (self.OptimizedLSTMCell_0, self.OptimizedLSTMCell_1))


class DeepSpeech(FlaxNamedModule):
    """spect [B, freq, time, 1] -> logits [B, T', num_classes]; 161
    frequency bins (AN4's spectrograms)."""

    def __init__(self, num_classes: int = 29, rnn_hidden: int = 800,
                 num_layers: int = 5, freq: int = 161,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(1, 32, (41, 11), stride=(2, 2),
                             padding=(20, 5))
        self.BatchNorm_0 = BatchNorm(32)
        self.Conv_1 = Conv2d(32, 32, (21, 11), stride=(2, 1),
                             padding=(10, 5))
        self.BatchNorm_1 = BatchNorm(32)
        f = (freq + 2 * 20 - 41) // 2 + 1
        f = (f + 2 * 10 - 21) // 2 + 1
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"BatchRNN_{i}", BatchRNN(
                f * 32 if i == 0 else rnn_hidden, rnn_hidden,
                batch_norm=i > 0))
        self.BatchNorm_2 = BatchNorm(rnn_hidden, axes=(0, 1))
        self.Dense_0 = Linear(rnn_hidden, num_classes, bias=False)
        set_compute_dtype(self, dtype)

    def forward(self, spect, train: bool = True, update_stats: bool = True):
        x = spect.permute(0, 3, 1, 2)
        x = hardtanh(self.BatchNorm_0(self.Conv_0(x), train, update_stats))
        x = hardtanh(self.BatchNorm_1(self.Conv_1(x), train, update_stats))
        b, c, f, t = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b, t, f * c)
        for i in range(self.num_layers):
            x = self.get_submodule(f"BatchRNN_{i}")(x, train, update_stats)
        x = self.BatchNorm_2(x, train, update_stats)
        return self.Dense_0(x).to(torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """lecun-normal conv and head kernels, zero conv biases, the LSTM
        cells' own initialisers (``LSTMCell.init_weights``); drawn from
        ``generator``, not JAX's draws."""
        for m in (self.Conv_0, self.Conv_1, self.Dense_0):
            w = m.weight
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(w[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        for m in self.modules():
            if isinstance(m, LSTMCell):
                m.init_weights(generator)
