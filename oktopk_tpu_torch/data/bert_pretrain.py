"""BERT pretraining examples: sentence pairs, MLM masking and NSP.

Counterpart of ``oktopk_tpu/data/bert_pretrain.py`` (the reference's
``BERTDataset``, BERT/bert/main_bert.py:257-366, and
``convert_example_to_features``, :528-614): sentence-pair examples from a
sentence-per-line corpus (blank lines between documents), 50% random
next sentences, and the 15% masking (80% [MASK] / 10% random / 10% kept,
label -1 elsewhere). numpy only, with the same ``RandomState`` draws in
the same order as the JAX package, so one corpus and seed give the same
batches."""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from oktopk_tpu_torch.data.tokenization import FullTokenizer


def load_documents(path: str) -> List[List[str]]:
    """Corpus file(s): one sentence per line, blank line between documents."""
    docs: List[List[str]] = [[]]
    files = ([os.path.join(path, f) for f in sorted(os.listdir(path))]
             if os.path.isdir(path) else [path])
    for fname in files:
        with open(fname, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    if docs[-1]:
                        docs.append([])
                else:
                    docs[-1].append(line)
    return [d for d in docs if len(d) >= 2]


def mask_tokens(ids: np.ndarray, rng: np.random.RandomState,
                vocab_size: int, mask_id: int, special_mask: np.ndarray,
                mlm_prob: float = 0.15):
    """15% positions: 80% -> [MASK], 10% -> random, 10% -> unchanged;
    labels are the original ids at masked positions, -1 elsewhere."""
    labels = np.full_like(ids, -1)
    cand = (~special_mask) & (rng.rand(*ids.shape) < mlm_prob)
    labels[cand] = ids[cand]
    r = rng.rand(*ids.shape)
    ids = np.where(cand & (r < 0.8), mask_id, ids)
    rand_ids = rng.randint(0, vocab_size, size=ids.shape)
    ids = np.where(cand & (r >= 0.8) & (r < 0.9), rand_ids, ids)
    return ids, labels


def pretrain_iterator(corpus_path: Optional[str], tokenizer: FullTokenizer,
                      batch_size: int, max_seq_len: int = 128,
                      seed: int = 0,
                      vocab_size: int = 30522) -> Iterator[Dict]:
    """Yield MLM+NSP batches from a corpus on disk."""
    docs = load_documents(corpus_path)
    rng = np.random.RandomState(seed)
    mask_id = tokenizer.vocab.get("[MASK]", 4)
    cls_id = tokenizer.vocab.get("[CLS]", 2)
    sep_id = tokenizer.vocab.get("[SEP]", 3)

    def one_example():
        d = docs[rng.randint(len(docs))]
        i = rng.randint(len(d) - 1)
        a = d[i]
        if rng.rand() < 0.5:
            b, nsp = d[i + 1], 0              # IsNext = 0 (reference label)
        else:
            rd = docs[rng.randint(len(docs))]
            b, nsp = rd[rng.randint(len(rd))], 1
        ids, types, mask = tokenizer.encode_pair(a, b, max_seq_len)
        return np.asarray(ids), np.asarray(types), np.asarray(mask), nsp

    while True:
        ids = np.zeros((batch_size, max_seq_len), np.int32)
        types = np.zeros_like(ids)
        attn = np.zeros_like(ids)
        nsp = np.zeros((batch_size,), np.int32)
        for b in range(batch_size):
            ids[b], types[b], attn[b], nsp[b] = one_example()
        special = (ids == cls_id) | (ids == sep_id) | (attn == 0)
        masked, labels = mask_tokens(ids, rng, vocab_size, mask_id, special)
        yield {"input_ids": masked.astype(np.int32),
               "token_type_ids": types,
               "attention_mask": attn,
               "mlm_labels": labels.astype(np.int32),
               "nsp_labels": nsp}
