"""PTB language-model LSTM: a 1500-d embedding, two 1500-wide LSTM
layers, dropout (rate 1 - ``dropout_keep``) after the embedding and
after each layer, and a Dense head with a bias to the vocabulary.

Counterpart of ``oktopk_tpu/models/lstm.py``: submodules carry the flax
names (``Embed_0``, ``OptimizedLSTMCell_0``, ``_1``, ``Dense_0``;
``models/layout.py``). Each step starts from a zero carry and the model
returns the logits only, as the JAX Trainer uses its model
(``oktopk_tpu/train/trainer.py:599-603`` ignores the returned carry);
the reference's carry across iterations is not what the JAX package
does. Dropout draws flax's masks under the apply's dropout key ``rng``:
the one ``Dropout_0`` module runs after the embedding and after each
layer, so its sites are ``("Dropout_0", 1)``, ``2``, ``3``
(``dropout_sites``).
"""

from __future__ import annotations

import math

import torch

from oktopk_tpu_torch.models.layers import (Embedding, Linear, SiteKeys,
                                            dropout, promote,
                                            set_compute_dtype, site_hashes)
from oktopk_tpu_torch.models.layout import FlaxNamedModule
from oktopk_tpu_torch.models.rnn import LSTMCell, lstm, lstm_written_out


def dropout_sites(num_layers: int = 2):
    """flax's ``make_rng("dropout")`` suffixes of one apply, in order."""
    return [("Dropout_0", i + 1) for i in range(num_layers + 1)]


class PTBLSTM(FlaxNamedModule):
    """tokens [B, T] -> logits [B, T, vocab_size]."""

    def __init__(self, vocab_size: int = 10000, hidden_size: int = 1500,
                 num_layers: int = 2, dropout_keep: float = 0.35,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = 1.0 - dropout_keep
        self.num_layers = num_layers
        self.Embed_0 = Embedding(vocab_size, hidden_size)
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            LSTMCell(hidden_size, hidden_size))
        self.Dense_0 = Linear(hidden_size, vocab_size)
        self.site_hashes = site_hashes(dropout_sites(num_layers))
        set_compute_dtype(self, dtype)

    def forward(self, tokens, train: bool = True, rng=None):
        keys = (SiteKeys(rng, self.site_hashes)
                if train and self.rate > 0.0 else None)
        x = dropout(self.Embed_0(tokens.long()), self.rate, train, keys)
        for i in range(self.num_layers):
            cell = self.get_submodule(f"OptimizedLSTMCell_{i}")
            if self.compute_dtype is None:
                x = lstm(x, (cell,))
            else:                   # flax's cell, its carry in bfloat16
                (x,) = promote(self.compute_dtype, x)
                x = lstm_written_out(x, cell)
            x = dropout(x, self.rate, train, keys)
        return self.Dense_0(x).to(torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default initialisers (normal(1/sqrt(vocab)) embedding,
        lecun-normal head kernel, zero bias, the cells' own), drawn from
        ``generator``, not JAX's draws."""
        e = self.Embed_0.weight
        e.copy_(torch.randn(e.shape, generator=generator)
                / math.sqrt(e.shape[0]))
        w = self.Dense_0.weight
        w.copy_(torch.randn(w.shape, generator=generator)
                / math.sqrt(w.shape[1]))
        self.Dense_0.bias.zero_()
        for i in range(self.num_layers):
            self.get_submodule(f"OptimizedLSTMCell_{i}").init_weights(
                generator)
