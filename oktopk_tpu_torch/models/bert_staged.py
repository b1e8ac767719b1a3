"""Staged BERT: the pretraining model split for pipeline parallelism.

Counterpart of ``oktopk_tpu/models/bert_staged.py:45-157``. The split is
the JAX package's:

- **pipelined**: the ``num_layers`` ``BertLayer``s, ``layers_per_stage``
  a stage, each stage a ``StageBlock`` whose layers are named
  ``sub_0 .. sub_{k-1}`` (the JAX stage tree);
- **shared**: the embeddings, the pooler and the MLM/NSP heads, whose
  decoder re-ties the word-embedding table.

A ``StagedBertPretrain`` holds the stages its process runs (``stages``:
every stage for the stacked pipe comm, one across processes) and the
shared part. ``split``/``merge`` convert between the single-module
``BertForPreTraining`` ``state_dict`` and (``stage_stack``, ``shared``):
``stage_stack`` maps a stage key (``sub_j.<...>``) to a tensor with a
leading [num_stages] axis, ``shared`` maps the shared keys; both in the
torch layout (``convert.py`` carries them to the JAX trees and back).

Dropout follows the JAX pipeline's keys (H27): each ``BertLayer`` and the embeddings are applied as
top-level flax modules under one dropout key, so a layer's sites are
``("attention", 1)``, ``("Dropout_0", 1)``, ``("Dropout_0", 2)`` without
the ``bert/encoder/layer_i`` prefix of ``bert.dropout_sites``, and the
embeddings' site is ``("Dropout_0", 1)``. Every layer of every stage
draws the same masks for the same shapes under one key.

The pipeline computes in float32, as the JAX path does (its
``BertConfig`` has no dtype): a config with another dtype is refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from oktopk_tpu_torch.models.bert import (BertConfig, BertEmbeddings,
                                          BertForPreTraining, BertLayer,
                                          LayerNorm, gelu, sorted_leaves)
from oktopk_tpu_torch.models.layers import Linear, SiteKeys, site_hashes
from oktopk_tpu_torch.ops import prng

#: the dropout sites of one top-level ``BertLayer`` apply, in call order
LAYER_SITES = [("attention", 1), ("Dropout_0", 1), ("Dropout_0", 2)]
#: the dropout site of the top-level ``BertEmbeddings`` apply
EMBED_SITES = [("Dropout_0", 1)]
_LAYER_HASHES = site_hashes(LAYER_SITES)
_EMBED_HASHES = site_hashes(EMBED_SITES)

Leaf = Tuple[Tuple[str, ...], nn.Parameter, str]


class StageBlock(nn.Module):
    """``layers_per_stage`` BertLayers, named ``sub_0`` ... as the JAX
    stage tree."""

    def __init__(self, cfg: BertConfig, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for j in range(num_layers):
            self.add_module(f"sub_{j}", BertLayer(cfg))

    def forward(self, x, mask, train: bool, layer_keys=None):
        for j in range(self.num_layers):
            keys = None if layer_keys is None else SiteKeys.of(layer_keys)
            x = getattr(self, f"sub_{j}")(x, mask, train, keys)
        return x


class StagedBertPretrain(nn.Module):
    """BertForPreTraining in pipeline stages; holds ``stages`` (default:
    all of them) and the shared embeddings and heads."""

    def __init__(self, cfg: BertConfig, num_stages: int,
                 stages: Optional[Sequence[int]] = None):
        super().__init__()
        if cfg.num_layers % num_stages != 0:
            raise ValueError(f"num_layers={cfg.num_layers} not divisible "
                             f"by num_stages={num_stages}")
        if cfg.dtype != torch.float32:
            raise ValueError("the pipeline computes in float32, as the JAX "
                             f"package's does, not {cfg.dtype}")
        self.cfg = cfg
        self.num_stages = num_stages
        self.layers_per_stage = cfg.num_layers // num_stages
        self.stage_ids = list(range(num_stages) if stages is None
                              else stages)
        self.stages = nn.ModuleList(
            StageBlock(cfg, self.layers_per_stage) for _ in self.stage_ids)
        h = cfg.hidden_size
        self.embeddings = BertEmbeddings(cfg)
        self.pooler = Linear(h, h)
        self.mlm_dense = Linear(h, h)
        self.mlm_ln = LayerNorm(h, cfg.layer_norm_eps)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.nsp = Linear(h, 2)

    # ---- parameter layout ----------------------------------------------

    def stage_leaves(self, row: int) -> List[Leaf]:
        """Stage row ``row``'s (flax path, parameter, layout) in the JAX
        stage tree's order (``sub_0, sub_1, sub_10, ...``)."""
        return sorted_leaves(self.stages[row].named_parameters())

    def shared_leaves(self) -> List[Leaf]:
        """The shared part's leaves in the JAX ``shared`` tree's order."""
        return sorted_leaves((k, p) for k, p in self.named_parameters()
                             if not k.startswith("stages."))

    def shared_state(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.state_dict().items()
                if not k.startswith("stages.")}

    def split(self, params: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """``BertForPreTraining`` state_dict -> (stage_stack, shared)."""
        k = self.layers_per_stage
        stage_stack = {}
        for key in StageBlock(self.cfg, k).state_dict():
            j, rest = key.split(".", 1)
            jj = int(j[len("sub_"):])
            stage_stack[key] = torch.stack([
                params[f"bert.encoder.layers.{s * k + jj}.{rest}"]
                for s in range(self.num_stages)])
        shared = {}
        for key, v in params.items():
            if key.startswith("bert.encoder."):
                continue
            shared[key[len("bert."):] if key.startswith(
                ("bert.embeddings.", "bert.pooler.")) else key] = v
        return stage_stack, shared

    def merge(self, stage_stack: Dict[str, torch.Tensor],
              shared: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`split` (checkpoint interchange)."""
        k = self.layers_per_stage
        out = {}
        for key, v in shared.items():
            out["bert." + key if key.startswith(("embeddings.", "pooler."))
                else key] = v
        for key, v in stage_stack.items():
            j, rest = key.split(".", 1)
            jj = int(j[len("sub_"):])
            for s in range(self.num_stages):
                out[f"bert.encoder.layers.{s * k + jj}.{rest}"] = v[s]
        return out

    @torch.no_grad()
    def load_split(self, stage_stack: Dict[str, torch.Tensor],
                   shared: Dict[str, torch.Tensor]) -> None:
        """Take the held stages' rows of ``stage_stack`` and ``shared``."""
        for row, s in enumerate(self.stage_ids):
            self.stages[row].load_state_dict(
                {key: v[s] for key, v in stage_stack.items()})
        own = {k: v for k, v in self.state_dict().items()
               if not k.startswith("stages.")}
        missing = set(own) - set(shared)
        if missing:
            raise KeyError(f"shared lacks {sorted(missing)}")
        for key, t in own.items():
            t.copy_(shared[key])

    def stage_stack(self) -> Dict[str, torch.Tensor]:
        """The held stages' parameters stacked [len(stages), ...]."""
        sds = [m.state_dict() for m in self.stages]
        return {key: torch.stack([sd[key] for sd in sds])
                for key in sds[0]}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
        """flax's default initialisers, as ``BertForPreTraining``'s: the
        single module is drawn from ``generator`` and split, so every
        process draws the same weights from one seed. Returns the single
        module's state_dict (a warm start's template)."""
        full = BertForPreTraining(self.cfg)
        full.init_weights(generator)
        sd = full.state_dict()
        self.load_split(*self.split(sd))
        return sd

    # ---- functional pieces ---------------------------------------------

    @staticmethod
    def attn_mask(attention_mask: torch.Tensor) -> torch.Tensor:
        """[B, T] 0/1 -> boolean [B, 1, T, T] attend-mask (a broadcast
        view)."""
        B, T = attention_mask.shape
        m = attention_mask[:, None, None, :].to(torch.bool)
        return m.expand(B, 1, T, T)

    def embed(self, input_ids, token_type_ids, train: bool = False,
              rng=None):
        keys = (SiteKeys(rng, _EMBED_HASHES)
                if train and self.cfg.dropout > 0.0 else None)
        return self.embeddings(input_ids, token_type_ids, train, keys)

    def layer_keys(self, train: bool, rng) -> Optional[np.ndarray]:
        """[3, 2] uint32: one layer apply's site keys under ``rng`` (None
        without dropout)."""
        if not train or self.cfg.dropout == 0.0:
            return None
        return prng.site_keys(rng, _LAYER_HASHES)

    def apply_stage(self, stage: StageBlock, x, attn_mask,
                    train: bool = False, layer_keys=None):
        """Run one stage's ``layers_per_stage`` BertLayers; every layer
        draws its masks from ``layer_keys`` (``layer_keys(train, rng)``)."""
        return stage(x, attn_mask, train, layer_keys)

    def head_logits(self, h, train: bool = False):
        """(mlm_logits, nsp_logits) float32 from the final hidden states
        [B, T, H], the math of ``BertForPreTraining`` after the
        encoder."""
        del train
        pooled = torch.tanh(self.pooler(h[:, 0]))
        hm = self.mlm_ln(gelu(self.mlm_dense(h)))
        table = self.embeddings.word_embeddings.weight
        mlm = torch.matmul(hm, table.t()) + self.mlm_bias
        nsp = self.nsp(pooled)
        return mlm.to(torch.float32), nsp.to(torch.float32)

    def reference_loss(self, params: Dict[str, torch.Tensor], batch,
                       train: bool = False, rng=None) -> torch.Tensor:
        """The single-module loss on the same batch (the equivalence
        oracle); ``params`` is a ``BertForPreTraining`` state_dict."""
        from oktopk_tpu_torch.train import losses
        full = BertForPreTraining(self.cfg).to(
            next(iter(params.values())).device)
        full.load_state_dict(params)
        mlm, nsp = full(batch["input_ids"], batch["token_type_ids"],
                        batch["attention_mask"], train=train, rng=rng)
        loss, _ = losses.bert_pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                            batch["nsp_labels"])
        return loss

