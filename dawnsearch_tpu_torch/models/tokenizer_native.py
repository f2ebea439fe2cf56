"""Native WordPiece tokenizer: the C++ loop with the Python tokenizer's ids.

Port of dawnsearch_tpu/models/tokenizer_native.py. It wraps
native/tokenizer.cpp, whose Unicode behaviour comes from tables generated
from Python's unicodedata (native/gen_unicode_tables.py), so its ids equal
the pure-Python WordPieceTokenizer's (tests/test_torch_tokenizer_native.py
holds both to the reference's). The C++ side is lowercase only: a cased
vocab keeps the Python tokenizer. One ctypes call a text, as in the
reference; one handle serves every thread (encode is const in C++).
"""

from __future__ import annotations

import ctypes

from dawnsearch_tpu_torch.models.tokenizer import (CLS, PAD, SEP, UNK,
                                                   WordPieceTokenizer,
                                                   read_vocab, special_id)
from dawnsearch_tpu_torch.utils import nativelib


def native_available() -> bool:
    return nativelib.get() is not None


class NativeWordPieceTokenizer:
    """Drop-in for WordPieceTokenizer (same encode() contract)."""

    MAX_IDS = 8192  # scratch bound; callers always pass max_len anyway

    def __init__(self, vocab: dict[str, int], lowercase: bool = True):
        if not lowercase:
            raise ValueError("native tokenizer is lowercase-only (BERT "
                             "uncased family); use WordPieceTokenizer")
        lib = nativelib.get()
        if lib is None:
            raise RuntimeError("native library unavailable: "
                               f"{nativelib.build_error()}")
        self._lib = lib
        self.vocab = vocab
        inv = {i: t for t, i in vocab.items()}
        blob = "\n".join(inv.get(i, f"[unused{i}]")
                         for i in range(max(vocab.values()) + 1))
        data = blob.encode("utf-8")
        self._handle = lib.dawn_tok_new(data, len(data))
        # alias-aware (MPNet vocabs name these <pad>/<unk>/<s>/</s>; the
        # C++ side resolves the same aliases, tokenizer.cpp)
        self.pad_id = special_id(vocab, PAD)
        self.unk_id = special_id(vocab, UNK)
        self.cls_id = special_id(vocab, CLS)
        self.sep_id = special_id(vocab, SEP)

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True
                        ) -> "NativeWordPieceTokenizer":
        return cls(read_vocab(path), lowercase=lowercase)

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        return self._encode(text, max_len, None)

    def encode_counted(self, text: str, max_len: int | None = None
                       ) -> tuple[list[int], int]:
        """encode(text, max_len), and the length of the ids uncut."""
        full = ctypes.c_long(0)
        return self._encode(text, max_len, ctypes.byref(full)), full.value

    def _encode(self, text: str, max_len: int | None, full) -> list[int]:
        cap = min(max_len or self.MAX_IDS, self.MAX_IDS)
        out = (ctypes.c_int32 * cap)()
        raw = text.encode("utf-8", errors="ignore")
        n = self._lib.dawn_tok_encode(self._handle, raw, len(raw), cap, out,
                                      full)
        return list(out[:n])

    def encode_batch(self, texts: list[str], seq_len: int
                     ) -> tuple[list[list[int]], list[list[int]]]:
        ids_batch, mask_batch = [], []
        for t in texts:
            ids = self.encode(t, max_len=seq_len)
            mask = [1] * len(ids) + [0] * (seq_len - len(ids))
            ids_batch.append(ids + [self.pad_id] * (seq_len - len(ids)))
            mask_batch.append(mask)
        return ids_batch, mask_batch

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.dawn_tok_free(handle)


def best_tokenizer(vocab: dict[str, int], lowercase: bool = True):
    """Native when the library is loadable, Python otherwise (and for a
    cased vocab, which the C++ side does not take)."""
    if lowercase and native_available():
        return NativeWordPieceTokenizer(vocab, lowercase=lowercase)
    return WordPieceTokenizer(vocab, lowercase=lowercase)
