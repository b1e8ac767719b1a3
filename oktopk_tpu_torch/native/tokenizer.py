"""ctypes wrapper over the native WordPiece tokenizer
(``native/wordpiece.cpp``).

Counterpart of ``oktopk_tpu/native/tokenizer.py``: ``encode`` and
``encode_pair`` give ``data.tokenization.FullTokenizer``'s ids. It raises
when the library cannot be built (``data/loaders.py`` takes it only when
``native.resolve("tokenizer")`` says so)."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from oktopk_tpu_torch.native import require

# ids ``encode`` makes room for at first; a longer text grows the buffer
MAX_IDS = 4096


class NativeTokenizer:
    """Vocab-file WordPiece encoder backed by the C++ implementation."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True):
        with open(vocab_file, encoding="utf-8") as f:
            vocab_text = f.read()
        lines = vocab_text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()  # trailing newline is not an entry
        self._vocab = {tok: i for i, tok in enumerate(lines)}
        self.cls_id = self._vocab.get("[CLS]", 2)
        self.sep_id = self._vocab.get("[SEP]", 3)
        self._lib = require()
        buf = "\n".join(lines).encode("utf-8")
        self._handle = self._lib.okn_wp_new_from_buffer(
            buf, len(buf), 1 if do_lower_case else 0)
        if self._handle is None:
            raise RuntimeError(f"the native tokenizer refused {vocab_file}")

    @property
    def vocab(self):
        """token -> id mapping (drop-in for FullTokenizer.vocab)."""
        return self._vocab

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def encode(self, text: str) -> List[int]:
        """text -> wordpiece ids (no specials)."""
        utf8 = text.encode("utf-8")
        cap = MAX_IDS
        while True:
            out = np.empty(cap, np.int32)
            n = self._lib.okn_wp_encode(
                self._handle, utf8,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
            if n <= cap:  # n > cap signals truncation: grow and retry
                return out[:n].tolist()
            cap = int(n)

    def encode_pair(self, text_a: str, text_b: Optional[str],
                    max_len: int) -> Tuple[List[int], List[int], List[int]]:
        """[CLS] a [SEP] (b [SEP]) padded to max_len ->
        (input_ids, token_type_ids, attention_mask)."""
        ids = np.empty(max_len, np.int32)
        types = np.empty(max_len, np.int32)
        mask = np.empty(max_len, np.int32)
        p = ctypes.POINTER(ctypes.c_int32)
        self._lib.okn_wp_encode_pair(
            self._handle, text_a.encode("utf-8"),
            (text_b or "").encode("utf-8"), max_len,
            self.cls_id, self.sep_id,
            ids.ctypes.data_as(p), types.ctypes.data_as(p),
            mask.ctypes.data_as(p))
        return ids.tolist(), types.tolist(), mask.tolist()

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle",
                                                           None)
        if lib is not None and handle is not None:
            lib.okn_wp_free(handle)
