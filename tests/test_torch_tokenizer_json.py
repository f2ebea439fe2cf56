"""Byte-level BPE from a `tokenizers` tokenizer.json (ModernBERT ships
only that file): models/tokenizer_bpe.py::read_tokenizer_json feeds the
Python tokenizer and its native twin, which must give the ids of
`tokenizers.Tokenizer.from_file` on the same file, specials and the cut
at 8,192 included, on seeded mixed texts (ASCII, accents, CJK, emoji,
runs of spaces), with merges written as "a b" or ["a", "b"], with and
without an NFC normalizer and a prefix space."""

import json

import numpy as np
import pytest

from dawnsearch_tpu_torch.models.tokenizer_bpe import (ByteLevelBPETokenizer,
                                                       byte_to_unicode,
                                                       read_tokenizer_json)
from dawnsearch_tpu_torch.models.tokenizer_bpe_native import (
    NativeByteLevelBPETokenizer, best_bpe_tokenizer, native_available)

WORDS = ("the of and to in is was it for on that with as by at from this "
         "are cat dog naïve café über são tokyo 北京 search document query "
         "long page model window").split()
SPECIALS = {"[UNK]": 50280, "[CLS]": 50281, "[SEP]": 50282, "[PAD]": 50283,
            "[MASK]": 50284}
POOL = ["the", "cat", "naïve", "café", "北京", "東京都", "😀", "🚀x", "  ",
        "\n", "\t", "'s", "don't", "123", "4.5", "!!", "Ωmega", "ﬁ", "é",
        " ", "über", "São", "café", "é", " dog", "   x"]


def _file(path, *, merge_lists=False, normalizer=None, prefix=False):
    b2u = byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for w in WORDS:
        prev = b2u[32]
        for ch in "".join(b2u[b] for b in w.encode()):
            if prev + ch not in vocab:
                merges.append([prev, ch] if merge_lists else f"{prev} {ch}")
                vocab[prev + ch] = len(vocab)
            prev += ch
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for c, i in SPECIALS.items()]
    path.write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": normalizer} if normalizer else None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": prefix,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [],
            "special_tokens": {n: {"id": n, "ids": [SPECIALS[n]],
                                   "tokens": [n]}
                               for n in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "vocab": vocab, "merges": merges}},
        ensure_ascii=False), encoding="utf-8")
    return str(path)


def _texts(seed: int, n: int = 120) -> list[str]:
    rng = np.random.default_rng(seed)
    out = ["".join(rng.choice(POOL, int(rng.integers(1, 30))))
           for _ in range(n)]
    return out + [" ".join(WORDS) * 300, ""]  # past 8,192 pieces; empty


VARIANTS = {"strings": {}, "lists": {"merge_lists": True},
            "nfc": {"normalizer": "NFC"},
            "prefix": {"prefix": True, "normalizer": "NFC"}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("native", [False, True])
def test_ids_match_tokenizers(tmp_path, variant, native):
    tk = pytest.importorskip("tokenizers")
    if native and not native_available():
        pytest.skip("the native library did not build here")
    path = _file(tmp_path / "tokenizer.json", **VARIANTS[variant])
    ref = tk.Tokenizer.from_file(path)
    ref.enable_truncation(8192)
    cls = NativeByteLevelBPETokenizer if native else ByteLevelBPETokenizer
    tok = cls.from_json(path)
    assert (tok.cls_id, tok.sep_id, tok.pad_id) == (50281, 50282, 50283)
    for t in _texts(len(variant)):
        assert tok.encode(t, max_len=8192) == ref.encode(t).ids, repr(t)
    assert len(tok.encode(_texts(0)[-2], max_len=8192)) == 8192


@pytest.mark.parametrize("native", [False, True])
def test_encode_counted_counts_the_cut_in_one_pass(tmp_path, native):
    """encode_counted gives encode's cut ids and the uncut length, which
    models/encoder.py::tokenize_texts counts as tokens truncated."""
    if native and not native_available():
        pytest.skip("the native library did not build here")
    path = _file(tmp_path / "tokenizer.json", normalizer="NFC")
    cls = NativeByteLevelBPETokenizer if native else ByteLevelBPETokenizer
    tok = cls.from_json(path)
    for t in _texts(5):
        whole = tok.encode(t)
        for cap in (2, 5, 64, 8192):
            ids, n = tok.encode_counted(t, cap)
            assert ids == tok.encode(t, max_len=cap), repr(t)
            assert n == len(whole)


def test_reader_and_best_tokenizer(tmp_path):
    path = _file(tmp_path / "tokenizer.json", normalizer="NFC")
    vocab, merges, opts = read_tokenizer_json(path)
    assert opts == {"add_prefix_space": False, "normalizer": "NFC",
                    "cls_id": 50281, "sep_id": 50282}
    assert vocab["[PAD]"] == 50283 and all(len(m) == 2 for m in merges)
    tok = best_bpe_tokenizer(path)
    assert tok.encode("the cat", max_len=16)[0] == 50281


def test_reader_refuses_what_it_cannot_honour(tmp_path):
    path = tmp_path / "tokenizer.json"
    _file(path)
    data = json.loads(path.read_text(encoding="utf-8"))
    data["normalizer"] = {"type": "Lowercase"}
    path.write_text(json.dumps(data), encoding="utf-8")
    with pytest.raises(ValueError, match="normalizer"):
        read_tokenizer_json(str(path))


# -- Qwen3's layout: NFC, a Split on Qwen2's pattern, then ByteLevel without
# its regex; the template `$A <|endoftext|>` ---------------------------------

EOT = 151643
QWEN_WORDS = tuple(WORDS) + ("don", "it", "I", "hello", "world", "1234")
QWEN_POOL = list(POOL) + ["DON'T", "I'M", "'Ll", "x'S", "''s", "\r\n", "\n\n  ",
                    "(word", "...word", " .\n", "x\t y", ",,\n\n", "1,000",
                    "　", "—", "ſ", "'ſ", "ǅx", "٣٤"]


def _qwen_file(path) -> str:
    from dawnsearch_tpu_torch.models.tokenizer_bpe import QWEN2_PATTERN
    b2u = byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for w in QWEN_WORDS:
        for lead in ("", " "):
            prev = ""
            for ch in "".join(b2u[b] for b in (lead + w).encode()):
                if prev and prev + ch not in vocab:
                    merges.append(f"{prev} {ch}")
                    vocab[prev + ch] = len(vocab)
                prev += ch
    special = {"id": "<|endoftext|>", "type_id": 0}
    path.write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": EOT, "content": "<|endoftext|>",
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False,
                          "special": True}],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": False, "use_regex": False}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": special}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": special}],
            "special_tokens": {"<|endoftext|>": {
                "id": "<|endoftext|>", "ids": [EOT],
                "tokens": ["<|endoftext|>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                    "trim_offsets": False, "use_regex": False},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab,
                  "merges": merges}}, ensure_ascii=False), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("native", [False, True])
def test_qwen_layout_ids_match_tokenizers(tmp_path, native):
    """Qwen2's pre-tokenizer (digits one at a time, case-insensitive
    contractions, a letter run with one leading non-letter, punctuation
    with its newlines, newline runs) and the template's closing
    <|endoftext|>, which a cut at 8,192 keeps last, as `tokenizers` gives
    them; encode_counted counts the uncut ids."""
    tk = pytest.importorskip("tokenizers")
    if native and not native_available():
        pytest.skip("the native library did not build here")
    path = _qwen_file(tmp_path / "tokenizer.json")
    ref = tk.Tokenizer.from_file(path)
    ref.enable_truncation(8192)
    cls = NativeByteLevelBPETokenizer if native else ByteLevelBPETokenizer
    tok = cls.from_json(path)
    assert (tok.lead, tok.sep_id, tok.pad_id) == (False, EOT, EOT)
    rng = np.random.default_rng(23)
    texts = ["".join(rng.choice(QWEN_POOL, int(rng.integers(1, 30))))
             for _ in range(400)] + [" ".join(QWEN_WORDS) * 900, ""]
    for t in texts:
        assert tok.encode(t, max_len=8192) == ref.encode(t).ids, repr(t)
    cut, n = tok.encode_counted(texts[-2], 8192)
    assert len(cut) == 8192 and cut[-1] == EOT
    assert n == len(tok.encode(texts[-2]))
    for cap in (1, 2, 7):
        assert tok.encode("the cat sat", max_len=cap)[-1] == EOT


def test_qwen_layout_reader(tmp_path):
    path = _qwen_file(tmp_path / "tokenizer.json")
    _, _, opts = read_tokenizer_json(path)
    assert opts == {"add_prefix_space": False, "normalizer": "NFC",
                    "pretokenizer": "qwen2", "lead": False, "sep_id": EOT}
    data = json.loads(open(path, encoding="utf-8").read())
    data["pre_tokenizer"]["pretokenizers"][0]["pattern"]["Regex"] = r"\s+"
    (tmp_path / "other.json").write_text(json.dumps(data), encoding="utf-8")
    with pytest.raises(ValueError, match="Split"):
        read_tokenizer_json(str(tmp_path / "other.json"))
