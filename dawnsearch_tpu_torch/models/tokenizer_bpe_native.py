"""Native byte-level BPE: the C++ loop with the Python tokenizer's ids.

Port of dawnsearch_tpu/models/tokenizer_bpe_native.py, wrapping
native/bpe.cpp, the RoBERTa-family twin of tokenizer_native.py. Two
construction-time transforms make the C++ side exact without touching
Unicode there:

- vocab.json / merges.txt spellings are unmapped through the bijective
  GPT-2 byte<->unicode table into raw byte strings, so the C++ merge loop
  works on the pre-token's UTF-8 bytes (isomorphic to the Python merge
  loop over mapped characters);
- the pre-tokenizer's \\p{L} / \\p{N} / \\s classes were generated from the
  `regex` module itself into unicode_tables.h, so the hand-compiled
  scanner splits as `regex` does.

Neither needs `regex` at run time: the blobs are built from
unicode_to_byte() alone. tests/test_torch_bpe.py holds its ids to the
reference's Python BPE. One deliberate difference, the reference's: text
holding unpaired surrogates (which CPython str allows) is encoded with
errors="ignore" here, while the Python tokenizer would raise.
"""

from __future__ import annotations

import ctypes
import importlib.util
import struct

from dawnsearch_tpu_torch.models.tokenizer_bpe import (ByteLevelBPETokenizer,
                                                       unicode_to_byte)
from dawnsearch_tpu_torch.utils import nativelib


def native_available() -> bool:
    return nativelib.get() is not None


def _unmap(spelling: str, u2b: dict[str, int]) -> bytes | None:
    """Mapped-unicode token spelling -> raw bytes; None if any char is
    outside the byte table (specials like <s> stay Python-side only: the
    byte-level pre-tokenizer never produces them)."""
    out = bytearray()
    for ch in spelling:
        b = u2b.get(ch)
        if b is None:
            return None
        out.append(b)
    return bytes(out)


class NativeByteLevelBPETokenizer:
    """Drop-in for ByteLevelBPETokenizer (same encode contract)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 **options):
        lib = nativelib.get()
        if lib is None:
            raise RuntimeError("native library unavailable: "
                               f"{nativelib.build_error()}")
        self._lib = lib
        self.vocab = vocab
        # special ids, the normalizer and the prefix space resolved
        # exactly like the Python twin (options: its keyword arguments)
        py = ByteLevelBPETokenizer(vocab, [], **options)
        self.pad_id, self.unk_id = py.pad_id, py.unk_id
        self.cls_id, self.sep_id = py.cls_id, py.sep_id
        self.lead = py.lead
        self._prepare = py.prepare if (py.normalizer or
                                       py.add_prefix_space) else None

        u2b = unicode_to_byte()
        ventries: list[bytes] = []
        for tok, tid in vocab.items():
            raw = _unmap(tok, u2b)
            if raw is None:
                continue  # special token; unreachable from byte input
            ventries.append(struct.pack("<iI", tid, len(raw)) + raw)
        vocab_blob = struct.pack("<I", len(ventries)) + b"".join(ventries)

        mentries: list[bytes] = []
        for a, b in merges:
            ra, rb = _unmap(a, u2b), _unmap(b, u2b)
            if ra is None or rb is None:
                continue
            mentries.append(struct.pack("<I", len(ra)) + ra
                            + struct.pack("<I", len(rb)) + rb)
        merges_blob = struct.pack("<I", len(mentries)) + b"".join(mentries)

        self._handle = lib.dawn_bpe_new(
            vocab_blob, len(vocab_blob), merges_blob, len(merges_blob),
            self.unk_id, self.cls_id, self.sep_id)
        if not self._handle:
            raise RuntimeError("dawn_bpe_new rejected the vocab/merges blob")
        lib.dawn_bpe_configure(self._handle,
                               1 if py.pretokenizer == "qwen2" else 0,
                               1 if py.lead else 0)

    @classmethod
    def from_json(cls, path: str) -> "NativeByteLevelBPETokenizer":
        from dawnsearch_tpu_torch.models.tokenizer_bpe import \
            read_tokenizer_json
        vocab, merges, opts = read_tokenizer_json(path)
        return cls(vocab, merges, **opts)

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str
                   ) -> "NativeByteLevelBPETokenizer":
        # the Python twin's reader (its regex import waits for a pattern)
        py = ByteLevelBPETokenizer.from_files(vocab_path, merges_path)
        order = sorted(py.ranks, key=py.ranks.get)
        return cls(py.vocab, order)

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        return self._encode(text, max_len, None)

    def encode_counted(self, text: str, max_len: int | None = None
                       ) -> tuple[list[int], int]:
        """encode(text, max_len), and the length of the ids uncut (the
        Python twin's contract)."""
        full = ctypes.c_long(0)
        return self._encode(text, max_len, ctypes.byref(full)), full.value

    def _encode(self, text: str, max_len: int | None, full) -> list[int]:
        if self._prepare is not None:
            text = self._prepare(text)
        raw = text.encode("utf-8", errors="ignore")
        # explicit None check: max_len=0 is a real cap (the Python twin
        # returns just [cls, sep]), not "no limit"; a byte is at most one
        # piece, so len(raw) + 2 ids hold any text whole
        cap = len(raw) + 2 if max_len is None else min(max_len, len(raw) + 2)
        # encode always emits <s>...</s>, so >= 2 ids even at cap < 2
        # (the Python twin's cap = max(max_len-2, 0) + specials)
        out = (ctypes.c_int32 * max(cap, 2))()
        n = self._lib.dawn_bpe_encode(self._handle, raw, len(raw), cap, out,
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
            lib.dawn_bpe_free(handle)


def best_bpe_tokenizer(vocab_path: str, merges_path: str | None = None):
    """Native when the library is loadable, Python otherwise, from
    vocab.json + merges.txt or (merges_path None) a tokenizer.json. The
    Python twin needs `regex`, which it imports at its first text:
    without the library and without `regex` this raises now, naming both,
    rather than at a node's first query."""
    def make(cls):
        if merges_path is None:
            return cls.from_json(vocab_path)
        return cls.from_files(vocab_path, merges_path)
    if native_available():
        return make(NativeByteLevelBPETokenizer)
    if importlib.util.find_spec("regex") is None:
        raise RuntimeError(
            "no byte-level BPE tokenizer can run here: the native library "
            f"did not build ({nativelib.build_error()}) and the Python "
            "tokenizer needs the `regex` module, which is not installed")
    return make(ByteLevelBPETokenizer)

