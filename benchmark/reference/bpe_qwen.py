"""Byte-level BPE of Qwen3's tokenizer.json layout, in plain Python:
reference/bpe.py's GPT-2 byte table, merge loop and file reading, with
Qwen2's Split pattern written as a scanner over Unicode categories (the
card's machine lacks the `regex` module):

    (?i:'s|'t|'re|'ve|'m|'ll|'d) | [^\\r\\n\\p{L}\\p{N}]?\\p{L}+ | \\p{N}
    |  ?[^\\s\\p{L}\\p{N}]+[\\r\\n]* | \\s*[\\r\\n]+ | \\s+(?!\\S) | \\s+

each alternative tried in order at each position, and the template
`$A <|endoftext|>`: a text's ids are its pieces, cut to max_len - 1, and
<|endoftext|>, which a cut keeps last. It imports nothing of the port."""

from __future__ import annotations

import json
import unicodedata

from benchmark.reference.bpe import ByteLevelBPE, _kind

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def pretokenize(text: str) -> list[str]:
    """The Qwen2 pattern's matches over `text`, in order."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text[i] == "'":
            low = text[i + 1:i + 3].lower()
            suf = next((s for s in _CONTRACTIONS if low.startswith(s)), None)
            if suf is not None:
                out.append(text[i:i + 1 + len(suf)])
                i += 1 + len(suf)
                continue
        c = _kind(text[i])
        if c == "L" or (text[i] not in "\r\n" and c != "N" and i + 1 < n
                        and _kind(text[i + 1]) == "L"):
            k = i + 1
            while k < n and _kind(text[k]) == "L":
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if c == "N":
            out.append(text[i])
            i += 1
            continue
        o = i + 1 if text[i] == " " and i + 1 < n and \
            _kind(text[i + 1]) == "O" else i
        if _kind(text[o]) == "O":
            k = o + 1
            while k < n and _kind(text[k]) == "O":
                k += 1
            while k < n and text[k] in "\r\n":
                k += 1
            out.append(text[i:k])
            i = k
            continue
        k = i
        while k < n and text[k].isspace():
            k += 1
        nl = max((j for j in range(i, k) if text[j] in "\r\n"), default=-1)
        if nl >= 0:  # \s*[\r\n]+: through the run's last newline
            end = nl + 1
        else:        # \s+(?!\S), or a single \s+ before a non-space
            end = k if k == n or k - i == 1 else k - 1
        out.append(text[i:end])
        i = end
    return out


class QwenBPE(ByteLevelBPE):
    """tokenizer.json of Qwen3's layout -> encode(text, max_len): pieces
    cut to max_len - 1, then the template's closing special."""

    @classmethod
    def from_json(cls, path: str) -> "QwenBPE":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        vocab = dict(model["vocab"])
        merges = [m.split(" ", 1) if isinstance(m, str) else m
                  for m in model["merges"]]
        for tok in data.get("added_tokens") or []:
            vocab.setdefault(tok["content"], tok["id"])
        post = data["post_processor"]
        seq = [s["SpecialToken"]["id"] for s in post["single"]
               if "SpecialToken" in s]
        if "SpecialToken" in post["single"][0]:
            raise ValueError(f"{path}: a leading special is not Qwen3's "
                             "template")
        eos = post["special_tokens"][seq[-1]]["ids"][0]
        norm = data.get("normalizer")
        return cls(vocab, merges, eos, eos, None,
                   norm["type"] if norm else None, False)

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        if self.normalizer:
            text = unicodedata.normalize(self.normalizer, text)
        cap = None if max_len is None else max(max_len - 1, 0)
        ids: list[int] = []
        for m in pretokenize(text):
            ids += self._bpe("".join(self._b2u[b] for b in m.encode()))
            if cap is not None and len(ids) >= cap:
                ids = ids[:cap]
                break
        return ids + [self.sep_id]
