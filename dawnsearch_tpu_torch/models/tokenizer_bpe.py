"""Byte-level BPE tokenizer (RoBERTa family), host-side.

Port of dawnsearch_tpu/models/tokenizer_bpe.py, unchanged but for its
import root. The RoBERTa family of sentence-transformers
(all-distilroberta-v1, all-roberta-large-v1, msmarco-distilroberta...)
ships a byte-level BPE vocab (vocab.json + merges.txt), not a WordPiece
vocab.txt. This is a from-scratch byte-level BPE, the GPT-2 scheme
RoBERTa adopted:

1. Pre-tokenize with a regex that keeps leading spaces attached to the
   following word (`" ?\\p{L}+"` etc.), so spacing survives round-trips.
2. Map each pre-token's UTF-8 bytes through a 256-entry byte->unicode
   table of printable characters (no byte is ever <unk>; the table
   shifts unprintable bytes into a private range).
3. Greedily apply the learned merge list: always merge the
   lowest-ranked adjacent pair until no listed pair remains.

It also holds a small BPE trainer (`train_bpe`), the BPE twin of
tokenizer.build_vocab_from_corpus. The pre-tokenizer's \\p classes need
the third-party `regex` module, imported only when a pattern is first
needed (`_pattern`): where it is not installed, the native twin
(models/tokenizer_bpe_native.py) tokenizes without it.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import unicodedata

from dawnsearch_tpu_torch.models.tokenizer import CLS, PAD, SEP, UNK, special_id

# RoBERTa's special-token names (vocab.json rows 0-3 + <mask> at the end
# in the published checkpoints; resolution goes through
# tokenizer.special_id so either naming scheme works).
BOS, EOS, PAD_TOK, UNK_TOK, MASK_TOK = "<s>", "</s>", "<pad>", "<unk>", "<mask>"

# GPT-2 pre-tokenization: contraction suffixes, space-prefixed
# letter/number/other runs, then residual whitespace. \p classes need
# the third-party `regex` module (stdlib `re` lacks them).
_PRETOKEN_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+"
)


# Qwen2's Split pattern (Qwen3's tokenizer.json): case-insensitive
# contractions, a letter run with one leading non-letter, single digits,
# punctuation runs with their newlines, newline runs
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# the pre-tokenizers this reader takes, by name
PATTERNS = {"gpt2": _PRETOKEN_PATTERN, "qwen2": QWEN2_PATTERN}


@functools.lru_cache(maxsize=2)
def _pattern(kind: str = "gpt2"):
    import regex

    return regex.compile(PATTERNS[kind])


@functools.lru_cache(maxsize=1)
def byte_to_unicode() -> dict[int, str]:
    """Bijective byte -> printable-unicode-char table (GPT-2 scheme).

    The three printable Latin-1 ranges map to themselves; the remaining
    68 bytes (controls, space, DEL, soft hyphen…) map to U+0100+i so
    every byte has a visible, json-safe spelling in vocab/merges files.
    """
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table: dict[int, str] = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


@functools.lru_cache(maxsize=1)
def unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in byte_to_unicode().items()}


def _adjacent_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word, word[1:]))


def _merge_pair(word: tuple[str, ...], a: str, b: str) -> tuple[str, ...]:
    """Replace every non-overlapping (a, b) adjacency in `word` with the
    fused symbol — the one merge semantics shared by the encoder's
    rank loop and the trainer (they must never diverge)."""
    merged: list[str] = []
    i = 0
    while i < len(word):
        if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
            merged.append(a + b)
            i += 2
        else:
            merged.append(word[i])
            i += 1
    return tuple(merged)


_NORMALIZERS = ("NFC", "NFD", "NFKC", "NFKD")


def read_tokenizer_json(path: str) -> tuple[dict[str, int],
                                            list[tuple[str, str]], dict]:
    """A `tokenizers` tokenizer.json of a byte-level BPE (ModernBERT's,
    GPT-2's, Qwen3's) -> (vocab, merges, options). The vocab is the
    model's plus the added tokens (so the specials resolve by name);
    merges are read as "a b" strings or ["a", "b"] pairs. options: cls_id
    and sep_id from the post-processor (TemplateProcessing: the special
    before and after $A, and `lead` False where none comes before, as in
    Qwen3's `$A <|endoftext|>`; RobertaProcessing: cls and sep),
    add_prefix_space from the ByteLevel pre-tokenizer, `pretokenizer`
    "qwen2" for a Split on Qwen2's pattern before a ByteLevel without its
    regex (any other Split is refused), and the normalizer (NFC, NFD,
    NFKC, NFKD or None; any other is refused). Special tokens written in a
    text are not split out of it before the BPE, as `tokenizers` would: a
    deployment's page text does not hold them."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    model = data.get("model") or {}
    if model.get("type", "BPE") != "BPE":
        raise ValueError(f"{path}: model type {model.get('type')!r} is not "
                         "a byte-level BPE")
    vocab = dict(model["vocab"])
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in model.get("merges", [])]
    for tok in data.get("added_tokens") or []:
        vocab.setdefault(tok["content"], tok["id"])

    def parts(node, kind):
        if not node:
            return []
        if node.get("type") == "Sequence":
            key = "pretokenizers" if kind == "pre" else (
                "processors" if kind == "post" else "normalizers")
            return [p for n in node.get(key, []) for p in parts(n, kind)]
        return [node]

    opts: dict = {"add_prefix_space": False, "normalizer": None}
    for node in parts(data.get("normalizer"), "norm"):
        if node.get("type") not in _NORMALIZERS:
            raise ValueError(f"{path}: normalizer {node.get('type')!r} is "
                             f"not supported ({', '.join(_NORMALIZERS)})")
        opts["normalizer"] = node["type"]
    for node in parts(data.get("pre_tokenizer"), "pre"):
        if node.get("type") == "ByteLevel":
            opts["add_prefix_space"] = bool(node.get("add_prefix_space"))
        elif node.get("type") == "Split":
            pat = (node.get("pattern") or {}).get("Regex")
            if pat != QWEN2_PATTERN or node.get("behavior") != "Isolated" \
                    or node.get("invert"):
                raise ValueError(f"{path}: a Split pre-tokenizer on "
                                 f"{pat!r} is not supported (only Qwen2's "
                                 "pattern, isolated)")
            opts["pretokenizer"] = "qwen2"
    for node in parts(data.get("post_processor"), "post"):
        if node.get("type") == "TemplateProcessing":
            specials = node.get("special_tokens", {})
            single = node.get("single", [])
            seq = [s["SpecialToken"]["id"] for s in single
                   if "SpecialToken" in s]
            if seq:
                if "SpecialToken" in single[0]:
                    opts["cls_id"] = specials[seq[0]]["ids"][0]
                else:
                    opts["lead"] = False
                opts["sep_id"] = specials[seq[-1]]["ids"][0]
        elif node.get("type") == "RobertaProcessing":
            opts["cls_id"], opts["sep_id"] = node["cls"][1], node["sep"][1]
    return vocab, merges, opts


class ByteLevelBPETokenizer:
    """vocab.json + merges.txt (or a tokenizer.json: `from_json`) -> the
    WordPieceTokenizer serving interface (pad/unk/cls/sep ids, encode,
    encode_batch), so SentenceEncoder and the ingest pipeline are
    tokenizer-agnostic. cls_id / sep_id override the ids found by name;
    `normalizer` (NFC, ...) and `add_prefix_space` (a space before a text
    that does not start with one) apply to each text before the
    pre-tokenizer, as a tokenizer.json's normalizer and ByteLevel
    pre-tokenizer do; `pretokenizer` names its pattern (PATTERNS). With
    lead=False a text's ids are its pieces and sep_id (Qwen3's `$A
    <|endoftext|>`), and a vocab without a pad or unk token pads with
    sep_id (a byte-level BPE never needs unk)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 cls_id: int | None = None, sep_id: int | None = None,
                 add_prefix_space: bool = False,
                 normalizer: str | None = None, lead: bool = True,
                 pretokenizer: str = "gpt2"):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.lead = lead
        self.pretokenizer = pretokenizer
        self.sep_id = special_id(vocab, SEP) if sep_id is None else sep_id
        if lead:
            self.cls_id = special_id(vocab, CLS) if cls_id is None else cls_id
            self.pad_id = special_id(vocab, PAD)
            self.unk_id = special_id(vocab, UNK)
        else:
            self.cls_id = self.sep_id if cls_id is None else cls_id
            self.pad_id = self._named(PAD)
            self.unk_id = self._named(UNK)
        self.add_prefix_space = add_prefix_space
        self.normalizer = normalizer
        self._b2u = byte_to_unicode()
        self._cache: dict[str, list[str]] = {}

    def _named(self, tok: str) -> int:
        try:
            return special_id(self.vocab, tok)
        except ValueError:
            return self.sep_id

    @classmethod
    def from_json(cls, path: str) -> "ByteLevelBPETokenizer":
        vocab, merges, opts = read_tokenizer_json(path)
        return cls(vocab, merges, **opts)

    def prepare(self, text: str) -> str:
        """The text the pre-tokenizer sees: normalized, and with the
        prefix space where the file asks for one."""
        if self.normalizer:
            text = unicodedata.normalize(self.normalizer, text)
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        return text

    # -- file I/O (HF layout: vocab.json token->id, merges.txt one
    # space-separated pair per line, optional "#version" header) --

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str
                   ) -> "ByteLevelBPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                line = line.rstrip("\n")
                # Parity target is the FAST tokenizer (the `tokenizers`
                # crate the reference links, Cargo.toml:52): it skips
                # "#version" header lines wherever they appear, and
                # every other non-blank line is a merge. (HF's *slow*
                # RobertaTokenizer instead drops line 1 unconditionally
                # — divergent only for headerless nonstandard files.)
                # Byte-level merges can start with '#' ("# #", "## ##"
                # — real GPT-2/RoBERTa merges.txt has them), so a
                # blanket '#' comment skip would silently drop merges.
                if line.startswith("#version"):
                    continue
                if not line.strip():
                    continue
                # split() (not split(" ")): byte-level tokens never
                # contain a literal space (it maps to Ġ), so this just
                # tolerates stray/duplicate whitespace like HF does
                parts = line.split()
                if len(parts) != 2:
                    raise ValueError(
                        f"{merges_path}:{lineno}: expected 'A B' merge "
                        f"pair, got {line!r}")
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    def save(self, directory: str) -> tuple[str, str]:
        vocab_path = os.path.join(directory, "vocab.json")
        merges_path = os.path.join(directory, "merges.txt")
        with open(vocab_path, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        order = sorted(self.ranks, key=self.ranks.get)
        with open(merges_path, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in order:
                f.write(f"{a} {b}\n")
        return vocab_path, merges_path

    # -- core BPE --

    def _bpe(self, token: str) -> list[str]:
        """Merge-by-rank loop over one byte-mapped pre-token."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        while len(word) > 1:
            pairs = _adjacent_pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            word = _merge_pair(word, *best)
        out = list(word)
        if len(self._cache) < 65536:  # bound the per-process cache
            self._cache[token] = out
        return out

    def tokenize(self, text: str, max_pieces: int | None = None
                 ) -> list[str]:
        """Text -> BPE piece strings (byte-mapped spelling, no specials).

        max_pieces stops pre-tokenizing once that many pieces exist —
        result-identical to tokenizing everything and slicing (each
        pre-token's pieces are independent of what follows), and it
        keeps 2048-char ingest pages from paying for pieces the seq
        bucket will drop."""
        pieces: list[str] = []
        b2u = self._b2u
        for m in _pattern(self.pretokenizer).finditer(self.prepare(text)):
            mapped = "".join(b2u[b] for b in m.group().encode("utf-8"))
            pieces.extend(self._bpe(mapped))
            if max_pieces is not None and len(pieces) >= max_pieces:
                break
        return pieces

    @property
    def n_specials(self) -> int:
        return 2 if self.lead else 1

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """<s> pieces </s> (pieces </s> without a leading special),
        truncated to max_len total (HF truncation=True keeps the first
        max_len less the specials pieces likewise, and the specials)."""
        cap = None if max_len is None else max(max_len - self.n_specials, 0)
        return self._specials(self.tokenize(text, max_pieces=cap), cap)

    def encode_counted(self, text: str, max_len: int | None = None
                       ) -> tuple[list[int], int]:
        """encode(text, max_len), and the length of the ids uncut: the
        pieces past the cut are merged too, once, only to count them."""
        pieces = self.tokenize(text)
        cap = None if max_len is None else max(max_len - self.n_specials, 0)
        return self._specials(pieces, cap), len(pieces) + self.n_specials

    def _specials(self, pieces: list[str], cap: int | None) -> list[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in pieces[:cap]]
        return ([self.cls_id] if self.lead else []) + ids + [self.sep_id]

    def decode(self, ids: list[int], skip_special: bool = True) -> str:
        special = {self.pad_id, self.cls_id, self.sep_id}
        u2b = unicode_to_byte()
        chars: list[str] = []
        for i in ids:
            if skip_special and i in special:
                continue
            chars.append(self.inv_vocab.get(i, ""))
        data = bytes(u2b[c] for c in "".join(chars) if c in u2b)
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: list[str], seq_len: int
                     ) -> tuple[list[list[int]], list[list[int]]]:
        """Fixed-length padded (input_ids, attention_mask) lists —
        WordPieceTokenizer.encode_batch twin."""
        ids_batch, mask_batch = [], []
        for t in texts:
            ids = self.encode(t, max_len=seq_len)
            mask = [1] * len(ids) + [0] * (seq_len - len(ids))
            ids = ids + [self.pad_id] * (seq_len - len(ids))
            ids_batch.append(ids)
            mask_batch.append(mask)
        return ids_batch, mask_batch


def train_bpe(texts: list[str], size: int = 4096,
              min_pair_freq: int = 2) -> ByteLevelBPETokenizer:
    """Train a byte-level BPE vocab from a corpus (zero-egress fallback;
    the BPE twin of tokenizer.build_vocab_from_corpus).

    Standard greedy pair-merge training over regex pre-tokens: start
    from the 256-char byte alphabet, repeatedly merge the most frequent
    adjacent pair (ties break lexicographically for determinism) until
    `size` is reached or no pair clears `min_pair_freq`. The saved
    vocab.json/merges.txt load identically into HF RobertaTokenizer —
    that cross-check is the trainer's parity test."""
    b2u = byte_to_unicode()
    pat = _pattern()
    word_freq: collections.Counter[tuple[str, ...]] = collections.Counter()
    for text in texts:
        for m in pat.findall(text):
            word_freq[tuple(b2u[b] for b in m.encode("utf-8"))] += 1

    specials = [BOS, PAD_TOK, EOS, UNK_TOK]
    alphabet = [b2u[b] for b in range(256)]
    vocab_list = specials + sorted(alphabet)
    merges: list[tuple[str, str]] = []
    words = dict(word_freq)
    while len(vocab_list) + 1 < size:  # +1: <mask> appended at the end
        pair_freq: collections.Counter[tuple[str, str]] = collections.Counter()
        for word, freq in words.items():
            for pair in zip(word, word[1:]):
                pair_freq[pair] += freq
        if not pair_freq:
            break
        top = max(pair_freq.values())
        if top < min_pair_freq:
            break
        best = min(p for p, f in pair_freq.items() if f == top)
        merges.append(best)
        vocab_list.append(best[0] + best[1])
        a, b = best
        new_words: dict[tuple[str, ...], int] = {}
        for word, freq in words.items():
            key = word if a not in word else _merge_pair(word, a, b)
            new_words[key] = new_words.get(key, 0) + freq
        words = new_words
    vocab_list.append(MASK_TOK)
    vocab = {t: i for i, t in enumerate(vocab_list)}
    return ByteLevelBPETokenizer(vocab, merges)
