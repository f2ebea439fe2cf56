"""WordPiece tokenizer (BERT-uncased family), host-side.

The reference uses HF `tokenizers` with BatchLongest padding
(embedding_service.rs:101-113). Batch-longest padding is hostile to XLA
(every batch a new shape => recompile), so we pad to fixed *seq-length
buckets* instead (see encoder.py). This module is a from-scratch
WordPiece implementation — basic cleaning, lowercasing + accent
stripping, punctuation splitting, CJK isolation, greedy longest-match
subwords — verified in tests against HF `BertTokenizerFast` built from
the same vocab file. It loads any standard `vocab.txt`, and can build a
self-contained vocab from a corpus when no pretrained vocab exists
(zero-egress environments).
"""

from __future__ import annotations

import collections
import unicodedata

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
MAX_WORD_CHARS = 100  # HF WordPiece max_input_chars_per_word


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """Clean + whitespace/punctuation/CJK split (BERT BasicTokenizer)."""
    out_chars: list[str] = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out_chars += [" ", ch, " "]
        elif unicodedata.category(ch) == "Zs" or ch in " \t\n\r":
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    tokens: list[str] = []
    for tok in "".join(out_chars).split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
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


# RoBERTa/MPNet-style vocabs name the same four specials differently
# (all-mpnet-base-v2 vocab.txt: <s>=0 <pad>=1 </s>=2 <unk>=3); accept
# either naming so one tokenizer serves both encoder families.
# PRECEDENCE MATTERS: the MPNet vocab PREPENDS <s>/<pad>/</s>/<unk> to
# the full BERT vocab, whose body still contains the literal strings
# "[PAD]"/"[CLS]"/"[SEP]" — so for pad/cls/sep the <...> alias must WIN
# when both exist (BERT-first resolution framed sequences with
# [CLS]=105/[SEP]=106 and refused the real checkpoint's pad). [UNK] is
# the one exception: HF MPNetTokenizer's unk_token IS "[UNK]", so the
# BERT name keeps precedence there.
_SPECIAL_ALIASES = {PAD: "<pad>", UNK: "<unk>", CLS: "<s>", SEP: "</s>"}


def special_id(vocab: dict[str, int], tok: str) -> int:
    """Resolve a special token across both naming schemes (precedence
    note above); raises if the vocab has neither name."""
    alias = _SPECIAL_ALIASES[tok]
    order = (tok, alias) if tok == UNK else (alias, tok)
    for name in order:
        if name in vocab:
            return vocab[name]
    raise ValueError(f"vocab missing special token {tok}/{alias}")


def read_vocab(path: str) -> dict[str, int]:
    """vocab.txt -> {token: line number}."""
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\r\n")] = i
    return vocab


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int], lowercase: bool = True):
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.pad_id = special_id(vocab, PAD)
        self.unk_id = special_id(vocab, UNK)
        self.cls_id = special_id(vocab, CLS)
        self.sep_id = special_id(vocab, SEP)

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        return cls(read_vocab(path), lowercase=lowercase)

    def save_vocab(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for i in range(len(self.inv_vocab)):
                f.write(self.inv_vocab[i] + "\n")

    def _wordpiece(self, word: str) -> list[str]:
        """Greedy longest-match-first subword split."""
        if len(word) > MAX_WORD_CHARS:
            return [UNK]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in basic_tokenize(text, lowercase=self.lowercase):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """[CLS] tokens [SEP], truncated to max_len total."""
        return self.encode_counted(text, max_len)[0]

    def encode_counted(self, text: str, max_len: int | None = None
                       ) -> tuple[list[int], int]:
        """encode(text, max_len), and the length of the ids uncut."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        n = len(ids) + 2
        if max_len is not None:
            ids = ids[: max_len - 2]
        return [self.cls_id] + ids + [self.sep_id], n

    def encode_batch(
        self, texts: list[str], seq_len: int
    ) -> tuple[list[list[int]], list[list[int]]]:
        """Fixed-length padded (input_ids, attention_mask) lists."""
        ids_batch, mask_batch = [], []
        for t in texts:
            ids = self.encode(t, max_len=seq_len)
            mask = [1] * len(ids) + [0] * (seq_len - len(ids))
            ids = ids + [self.pad_id] * (seq_len - len(ids))
            ids_batch.append(ids)
            mask_batch.append(mask)
        return ids_batch, mask_batch


def build_vocab_from_corpus(
    texts: list[str], size: int = 30522, lowercase: bool = True
) -> dict[str, int]:
    """Self-contained vocab: specials + single chars + frequent words +
    frequent suffix pieces. Not a trained BPE/WordPiece — a functional
    fallback for zero-egress environments; load a real vocab.txt for
    pretrained-checkpoint fidelity."""
    word_freq: collections.Counter[str] = collections.Counter()
    chars: set[str] = set()
    for t in texts:
        for w in basic_tokenize(t, lowercase=lowercase):
            word_freq[w] += 1
            chars.update(w)
    vocab_list = [PAD, UNK, CLS, SEP, MASK]
    for c in sorted(chars):
        vocab_list.append(c)
        vocab_list.append("##" + c)
    for w, _ in word_freq.most_common():
        if len(vocab_list) >= size:
            break
        if w not in chars:
            vocab_list.append(w)
    vocab_list = vocab_list[:size]
    return {t: i for i, t in enumerate(vocab_list)}
