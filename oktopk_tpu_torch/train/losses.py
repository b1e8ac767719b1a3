"""Loss functions (counterpart of ``oktopk_tpu/train/losses.py``: the CNN
and language-model cross entropies, CTC, and BERT's pretraining
loss)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over integer labels [B], computed in float32."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())


def lm_cross_entropy(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over [B, T] targets (PTB language modelling;
    perplexity = exp(loss)), computed in float32."""
    return F.cross_entropy(logits.to(torch.float32).flatten(0, -2),
                           targets.long().flatten())


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """CTC on per-frame logits [B, T, C], averaged over the batch: the
    negative log-likelihood of each sequence (``optax.ctc_loss``, which
    takes the log-softmax itself), then ``.mean()``. ``F.ctc_loss``'s
    default ``"mean"`` would divide each sequence by its label length, so
    the reduction is ``"none"``. Labels are [B, S], padded past their
    lengths. Where no alignment is feasible optax's log-epsilon gives a
    large finite loss and this one +inf (``zero_infinity=False``)."""
    logp = F.log_softmax(logits.to(torch.float32), -1).transpose(0, 1)
    per_seq = F.ctc_loss(logp, labels.long(), logit_lengths.long(),
                         label_lengths.long(), blank=blank_id,
                         reduction="none")
    return per_seq.mean()


def bert_pretrain_loss(mlm_logits: torch.Tensor, nsp_logits: torch.Tensor,
                       mlm_labels: torch.Tensor, nsp_labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked-LM cross entropy over the positions with a label >= 0,
    divided by max(count, 1), plus the mean next-sentence cross entropy
    (``oktopk_tpu/train/losses.py:44-55``). With no masked token the MLM
    term is 0, not the NaN of ``F.cross_entropy(ignore_index=-1)``."""
    mask = (mlm_labels >= 0).to(torch.float32)
    safe = torch.clamp(mlm_labels, min=0).long()
    per_tok = F.cross_entropy(mlm_logits.flatten(0, -2), safe.flatten(),
                              reduction="none").view(mlm_labels.shape)
    mlm = torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)
    nsp = F.cross_entropy(nsp_logits, nsp_labels.long())
    return mlm + nsp, {"mlm_loss": mlm, "nsp_loss": nsp}
