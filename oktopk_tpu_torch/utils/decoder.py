"""Greedy CTC decoding and the WER/CER metrics, on the host.

Counterpart of ``oktopk_tpu/utils/decoder.py`` (the reference's
VGG/decoder.py:23-197): ``levenshtein`` (the standard dynamic program),
``GreedyDecoder`` (argmax per frame, collapse repeats, drop blanks),
word and character error rates."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance (the reference uses the python-Levenshtein package;
    this is the standard DP, dependency-free)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class GreedyDecoder:
    """argmax-per-frame, collapse repeats, strip blanks."""

    def __init__(self, labels: str, blank_index: int = 0):
        self.labels = labels
        self.blank = blank_index

    def decode(self, logits: np.ndarray,
               lengths: np.ndarray = None) -> List[str]:
        """logits [B, T, C] -> list of decoded strings."""
        return self.decode_ids(np.argmax(logits, axis=-1), lengths)

    def decode_ids(self, ids: np.ndarray,
                   lengths: np.ndarray = None) -> List[str]:
        """Per-frame argmax ids [B, T] -> list of decoded strings (the
        argmax may come from the device)."""
        out = []
        for b in range(ids.shape[0]):
            t_max = int(lengths[b]) if lengths is not None else ids.shape[1]
            prev = -1
            chars = []
            for t in range(t_max):
                c = int(ids[b, t])
                if c != self.blank and c != prev:
                    chars.append(self.labels[c])
                prev = c
            out.append("".join(chars))
        return out

    @staticmethod
    def wer(hyp: str, ref: str) -> float:
        rw = ref.split()
        return levenshtein(hyp.split(), rw) / max(len(rw), 1)

    @staticmethod
    def cer(hyp: str, ref: str) -> float:
        return levenshtein(hyp, ref) / max(len(ref), 1)
