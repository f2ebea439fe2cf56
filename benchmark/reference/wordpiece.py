"""Frozen WordPiece (BERT uncased): the tokenizer the reference holds the
node's native tokenizer to.

A copy of dawnsearch_tpu_torch/models/tokenizer.py (basic_tokenize,
special_id, the greedy longest-match split and encode), kept here so the
yardstick does not move when the port's tokenizer does.
"""

from __future__ import annotations

import unicodedata

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"
MAX_WORD_CHARS = 100  # HF WordPiece max_input_chars_per_word
# an MPNet vocab names pad/cls/sep <pad>/<s>/</s>, and these win over the
# literal BERT names its body holds; [UNK] keeps precedence over <unk>
_ALIASES = {PAD: "<pad>", UNK: "<unk>", CLS: "<s>", SEP: "</s>"}


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str) -> list[str]:
    """Clean, split on whitespace, punctuation and CJK, lowercase and
    strip accents (BERT's BasicTokenizer)."""
    chars: list[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            chars += [" ", ch, " "]
        elif unicodedata.category(ch) == "Zs" or ch in " \t\n\r":
            chars.append(" ")
        else:
            chars.append(ch)
    tokens: list[str] = []
    for tok in "".join(chars).split():
        tok = "".join(c for c in unicodedata.normalize("NFD", tok.lower())
                      if unicodedata.category(c) != "Mn")
        cur: list[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


def special_id(vocab: dict[str, int], tok: str) -> int:
    alias = _ALIASES[tok]
    for name in ((tok, alias) if tok == UNK else (alias, tok)):
        if name in vocab:
            return vocab[name]
    raise ValueError(f"vocab has neither {tok} nor {alias}")


class WordPiece:
    def __init__(self, vocab: list[str]):
        self.vocab = {t: i for i, t in enumerate(vocab)}
        self.pad_id = special_id(self.vocab, PAD)
        self.unk_id = special_id(self.vocab, UNK)
        self.cls_id = special_id(self.vocab, CLS)
        self.sep_id = special_id(self.vocab, SEP)

    def _pieces(self, word: str) -> list[str] | None:
        if len(word) > MAX_WORD_CHARS:
            return None
        out, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return None
            out.append(cur)
            start = end
        return out

    def encode(self, text: str, max_len: int = 512) -> list[int]:
        """[CLS] ids [SEP], truncated to max_len ids in all."""
        ids: list[int] = []
        for word in basic_tokenize(text):
            pieces = self._pieces(word)
            ids += ([self.unk_id] if pieces is None
                    else [self.vocab[p] for p in pieces])
        return [self.cls_id] + ids[: max_len - 2] + [self.sep_id]
