"""Native language filter: exact parity with ingest/lang.py (the port's copy
of tests/test_lang_native.py).

The C++ twin (native/lang.cpp) sits on the ingest hot path — it was
built because is_english was the extraction stage's largest remaining
GIL share — and the contract is that it returns EXACTLY the Python
answers: same booleans and bit-equal ratios (both sides compute
integer-count quotients, so == holds when the counts match).
"""

import random

import pytest
import torch

from dawnsearch_tpu_torch.ingest import native
from dawnsearch_tpu_torch.ingest.lang import (
    _STOPWORDS, english_score, is_english, latin_ratio)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _native_library():
    """The port's native library must build here, or the C++ side would
    go untested."""
    assert native.nativelib.get() is not None, native.nativelib.build_error()


def c_funcs(text: str):
    lib = native.nativelib.get()
    raw = text.encode("utf-8", errors="ignore")
    return (bool(lib.dawn_is_english(raw, len(raw), 0.12, 0.85)),
            lib.dawn_english_score(raw, len(raw)),
            lib.dawn_latin_ratio(raw, len(raw)))


FIXTURES = [
    # accept: running English prose
    "The quick brown fox jumps over the lazy dog and it was the best "
    "of times, it was the worst of times.",
    # reject: non-English Latin-script prose (stopword gate)
    "Le renard brun rapide saute par-dessus le chien paresseux et "
    "c'était le meilleur des temps.",
    "Der schnelle braune Fuchs springt über den faulen Hund und es "
    "war die beste aller Zeiten.",
    # reject: non-Latin scripts (latin gate)
    "быстрая коричневая лиса прыгает через ленивую собаку и это было",
    "敏捷的棕色狐狸跳过懒狗这是最好的时代这是最坏的时代也是智慧的时代",
    "سريع الثعلب البني يقفز فوق الكلب الكسول وكان أفضل الأوقات",
    # punctuation/number-heavy English must still pass the word gate
    "The price is $4,299.00 — and it was 'the best' of the season! "
    "Scores: 10, 20, 30, 40 and the rest.",
    # apostrophes and strip-punct edges
    "don't can't won't it's the of and a to in is was for on that",
    # Unicode lower() edge: Turkish dotted capital I ('İ'.lower() is
    # 'i' + U+0307 combining dot, which is NOT alpha)
    "İstanbul is the largest city in Turkey and it has been a capital",
    # Kelvin sign lowers to ASCII 'k' (full-range lower mapping)
    "Kelvin the sign of and to in is was for on that with as by",
    # non-BMP letters (Deseret) — above-BMP alpha ranges
    "𐐔𐐯𐑅𐐨𐑉𐐯𐐻 text with the english stopwords of and to in is was",
    # degenerate inputs
    "", " ", "\t\n\r", "12345 67890 $$$ %%%", "a", "the",
    " the of and a to in ",
    # exactly around the 1024-cp sample boundary
    "the of and a to in is was for on " * 31,   # 1023 cps
    "the of and a to in is was for on " * 32,   # 1056 cps -> sampled
]


def test_fixture_parity():
    for t in FIXTURES:
        ce, cs, cl = c_funcs(t)
        assert ce == is_english(t), t[:60]
        assert cs == english_score(t), t[:60]
        assert cl == latin_ratio(t), t[:60]


def test_seeded_fuzz_parity():
    rng = random.Random(1234)
    pools = [(0x09, 0x0e), (0x1c, 0x21), (0x20, 0x7f), (0xa0, 0x300),
             (0x400, 0x500), (0x2000, 0x2070), (0x4e00, 0x5000),
             (0x10400, 0x10500), (0x1f300, 0x1f600)]
    for i in range(1500):
        n = rng.randrange(0, 4000)
        if rng.random() < 0.4:  # pure-ASCII: the byte fast path
            t = "".join(chr(rng.randrange(0x09, 0x7f)) for _ in range(n))
        else:
            t = "".join(chr(rng.randrange(*rng.choice(pools)))
                        for _ in range(n))
        if rng.random() < 0.5:
            t += " the of and a to in is was for on"
        ce, cs, cl = c_funcs(t)
        assert ce == is_english(t), (i, t[:80])
        assert cs == english_score(t), (i, t[:80])
        assert cl == latin_ratio(t), (i, t[:80])


def test_dispatch_uses_native_and_falls_back():
    # the ingest-facing entry point answers like the Python oracle
    assert native.is_english("the cat sat on the mat and it was good")
    assert not native.is_english("chat assis sur le tapis près de la")


def test_stopword_list_matches_python():
    """The C++ array is a hand-sorted copy of _STOPWORDS; catch drift
    by probing every word (and near-misses) through the scorer."""
    for w in sorted(_STOPWORDS):
        t = f"{w} xyzzy plugh"          # 1 stopword of 3 words
        _, cs, _ = c_funcs(t)
        assert cs == pytest.approx(1 / 3), w
    for w in ["was", "thee", "ofs", "zzz", "waz"]:
        t = f"{w} xyzzy plugh"
        _, cs, _ = c_funcs(t)
        assert cs == ((1 / 3) if w in _STOPWORDS else 0.0), w
