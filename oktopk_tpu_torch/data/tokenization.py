"""WordPiece tokenization.

Counterpart of ``oktopk_tpu/data/tokenization.py`` (the reference's
vendored BERT/bert/transformers/tokenization.py): ``BasicTokenizer``
(lowercase, strip accents by NFD, split punctuation by ``unicodedata``
category), greedy longest-match ``WordpieceTokenizer`` over a vocab file,
and ``FullTokenizer``, whose ids without a vocab file come from a
deterministic ``zlib.crc32`` hash sized to the model's table. Pure
Python, line for line the JAX package's, so both give the same ids."""

from __future__ import annotations

import os
import unicodedata
import zlib
from typing import Dict, List, Optional


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = text.lower()
            text = unicodedata.normalize("NFD", text)
            text = "".join(c for c in text
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif _is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out


class WordpieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars: int = 100):
        self.vocab = vocab
        self.unk = unk_token
        self.max_chars = max_chars

    def tokenize(self, token: str) -> List[str]:
        if len(token) > self.max_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces


class FullTokenizer:
    """BasicTokenizer -> WordpieceTokenizer -> ids."""

    SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

    def __init__(self, vocab_file: Optional[str] = None,
                 do_lower_case: bool = True, fallback_size: int = 30522):
        if vocab_file and os.path.exists(vocab_file):
            self.vocab: Dict[str, int] = {}
            with open(vocab_file, encoding="utf-8") as f:
                for i, line in enumerate(f):
                    self.vocab[line.rstrip("\n")] = i
            self.hash_fallback = False
        else:
            # deterministic hash vocab: specials pinned, everything else
            # bucketed — tokenization stays stable without the real file
            self.vocab = {t: i for i, t in enumerate(self.SPECIALS)}
            self.hash_fallback = True
            self.fallback_size = fallback_size
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordpieceTokenizer(self.vocab)

    @property
    def vocab_size(self) -> int:
        """Id-space size: every emitted id is < vocab_size (model embedding
        tables must be at least this big — OOB ids NaN silently on XLA)."""
        return self.fallback_size if self.hash_fallback else len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        if self.hash_fallback:
            return self.basic.tokenize(text)
        out = []
        for tok in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(tok))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        if self.hash_fallback:
            n = self.fallback_size
            ns = len(self.SPECIALS)
            # crc32, not builtin hash(): ids must be stable across
            # processes (a pretrain run and a later fine-tune warm-start
            # must agree), and hash() is salted per interpreter
            return [self.vocab.get(t) if t in self.vocab
                    else ns + (zlib.crc32(t.encode("utf-8")) % (n - ns))
                    for t in tokens]
        return [self.vocab.get(t, self.vocab["[UNK]"]) for t in tokens]

    def encode_pair(self, text_a: str, text_b: Optional[str],
                    max_len: int):
        """[CLS] a [SEP] (b [SEP]) with pair truncation (longest-first, the
        reference's _truncate_seq_pair) and padding to max_len.

        Returns (input_ids, token_type_ids, attention_mask)."""
        ta = self.tokenize(text_a)
        tb = self.tokenize(text_b) if text_b else []
        budget = max_len - (3 if tb else 2)
        while len(ta) + len(tb) > budget:
            (ta if len(ta) > len(tb) else tb).pop()
        tokens = ["[CLS]"] + ta + ["[SEP]"]
        types = [0] * len(tokens)
        if tb:
            tokens += tb + ["[SEP]"]
            types += [1] * (len(tb) + 1)
        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return (ids + [0] * pad, types + [0] * pad, mask + [0] * pad)
