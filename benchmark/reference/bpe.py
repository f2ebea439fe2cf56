"""Byte-level BPE from a `tokenizers` tokenizer.json, in plain Python: a
frozen copy of the port's Python byte-level BPE (its GPT-2 byte table,
its merge-by-rank loop, its reading of tokenizer.json's vocab, merges,
added tokens, post-processor, normalizer and prefix space), with the
GPT-2 pre-tokenizer written as a scanner over Unicode categories instead
of the `regex` module's \\p classes, which the card's machine lacks:

    's|'t|'re|'ve|'m|'ll|'d | ?\\p{L}+ | ?\\p{N}+ | ?[^\\s\\p{L}\\p{N}]+
    | \\s+(?!\\S) | \\s+

It imports nothing of the port."""

from __future__ import annotations

import functools
import json
import unicodedata

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=1)
def byte_to_unicode() -> dict[int, str]:
    """GPT-2's bijective byte -> printable character table."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


def _kind(ch: str) -> str:
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def pretokenize(text: str) -> list[str]:
    """The GPT-2 pattern's matches over `text`, in order."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text[i] == "'":
            suf = next((s for s in _CONTRACTIONS
                        if text.startswith(s, i + 1)), None)
            if suf is not None:
                out.append("'" + suf)
                i += 1 + len(suf)
                continue
        j = i + 1 if text[i] == " " and i + 1 < n and \
            not text[i + 1].isspace() else i
        kind = _kind(text[j])
        if kind != "S":
            k = j + 1
            while k < n and _kind(text[k]) == kind:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        k = i
        while k < n and text[k].isspace():
            k += 1
        # \s+(?!\S): all of a run at the end, else all but its last
        # character; a single one before a non-space is \s+ alone
        end = k if k == n or k - i == 1 else k - 1
        out.append(text[i:end])
        i = end
    return out


class ByteLevelBPE:
    """tokenizer.json -> encode(text, max_len): [CLS] pieces [SEP] ids,
    the pieces cut to max_len - 2."""

    def __init__(self, vocab: dict[str, int], merges: list, cls_id: int,
                 sep_id: int, unk_id: int | None, normalizer: str | None,
                 add_prefix_space: bool):
        self.vocab = vocab
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.cls_id, self.sep_id, self.unk_id = cls_id, sep_id, unk_id
        self.normalizer = normalizer
        self.add_prefix_space = add_prefix_space
        self._b2u = byte_to_unicode()
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_json(cls, path: str) -> "ByteLevelBPE":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        vocab = dict(model["vocab"])
        merges = [m.split(" ", 1) if isinstance(m, str) else m
                  for m in model["merges"]]
        for tok in data.get("added_tokens") or []:
            vocab.setdefault(tok["content"], tok["id"])
        post = data["post_processor"]
        if post["type"] == "RobertaProcessing":
            cls_id, sep_id = post["cls"][1], post["sep"][1]
        else:
            seq = [s["SpecialToken"]["id"] for s in post["single"]
                   if "SpecialToken" in s]
            cls_id = post["special_tokens"][seq[0]]["ids"][0]
            sep_id = post["special_tokens"][seq[-1]]["ids"][0]
        norm = data.get("normalizer")
        pre = data.get("pre_tokenizer") or {}
        return cls(vocab, merges, cls_id, sep_id,
                   vocab.get(model.get("unk_token") or "[UNK]"),
                   norm["type"] if norm else None,
                   bool(pre.get("add_prefix_space")))

    def _bpe(self, piece: str) -> list[int]:
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        word = list(piece)
        while len(word) > 1:
            best = min(range(len(word) - 1), key=lambda k: self.ranks.get(
                (word[k], word[k + 1]), 1 << 60))
            pair = (word[best], word[best + 1])
            if pair not in self.ranks:
                break
            merged, k = [], 0
            while k < len(word):
                if k < len(word) - 1 and (word[k], word[k + 1]) == pair:
                    merged.append(word[k] + word[k + 1])
                    k += 2
                else:
                    merged.append(word[k])
                    k += 1
            word = merged
        ids = [self.vocab.get(t, self.unk_id) for t in word]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        if self.normalizer:
            text = unicodedata.normalize(self.normalizer, text)
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        cap = None if max_len is None else max(max_len - 2, 0)
        ids: list[int] = []
        for m in pretokenize(text):
            ids += self._bpe("".join(self._b2u[b] for b in m.encode()))
            if cap is not None and len(ids) >= cap:
                ids = ids[:cap]
                break
        return [self.cls_id] + ids + [self.sep_id]
