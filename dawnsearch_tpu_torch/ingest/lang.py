"""English detection for the ingestion filter.

Port of dawnsearch_tpu/ingest/lang.py, unchanged in semantics. The
reference filters to English via the `whichlang` trigram classifier
(page_source.rs:119-121). Here: a stopword-ratio + script-ratio
heuristic — zero-dependency and conservative in the same direction
(prefer dropping a borderline page over indexing junk).

This filter sits on the ingest hot path, so it runs entirely on C fast
paths:

- ratios are computed over a bounded ~1 KB start/middle/end sample
  (mixed-language pages still show their non-English parts; the
  sample bounds the estimate error well below the thresholds);
- the script ratio counts BYTES of the UTF-8 encoding with
  bytes.translate deletion tables: ASCII letters vs non-ASCII lead
  bytes (= non-ASCII chars). Accented Latin letters count as
  non-ASCII, so French/German prose scores ~0.95 (still above the
  0.85 gate — the stopword gate is what rejects them);
- the stopword ratio uses str.split + a frozenset; the letter-bearing
  word check (denominator must not count numbers/punctuation runs)
  rides str.isalpha as its common case.

A C++ twin carries production traffic (native/lang.cpp, dispatched via
ingest/native.is_english) with exact parity, enforced by
tests/test_torch_lang_native.py: it runs with the GIL released, so the
pipeline's other stages keep running. This module stays the semantic
oracle and the fallback when the library isn't built.
"""

from __future__ import annotations

_STOPWORDS = frozenset(
    "the of and a to in is was for on that with as by at it from be are "
    "this an or his which have had not they her she he but were their has "
    "its will would there been we you all can more if no so what when who "
    "them some into only other time new may these than most also".split()
)

_SAMPLE = 1024
_PUNCT = ",.;:!?\"'()[]{}<>«»“”‘’—–-_/\\|*&%$#@~`+="

# bytes.translate deletion tables: keep only the class of interest
_ASCII_LETTERS = (bytes(range(ord("a"), ord("z") + 1))
                  + bytes(range(ord("A"), ord("Z") + 1)))
_DEL_NON_LETTER = bytes(b for b in range(256) if b not in _ASCII_LETTERS)
# UTF-8 lead bytes of non-ASCII chars are 0xC0-0xFF; continuation
# bytes 0x80-0xBF. Counting lead bytes counts non-ASCII CHARS.
_DEL_NON_LEAD = bytes(b for b in range(256) if b < 0xC0)


def _sample(text: str) -> str:
    """Start + middle + end slices, ~_SAMPLE chars total."""
    if len(text) <= _SAMPLE:
        return text
    third = _SAMPLE // 3
    mid = len(text) // 2
    return (text[:third] + " " + text[mid - third // 2: mid + third // 2]
            + " " + text[-third:])


def english_score(text: str) -> float:
    """Fraction of WORDS that are common-English stopwords (0..1).

    The denominator counts only letter-bearing tokens — matching the
    original [a-z']+ formulation — so numbers, dates, prices, and
    punctuation runs don't deflate the score (a stats-heavy English
    page must not fall under the 0.12 gate just for containing a score
    table)."""
    tokens = _sample(text).lower().split()
    sw = _STOPWORDS
    hits = 0
    words = 0
    for w in tokens:
        if w.isalpha():  # common case: ONE C call, no strip
            words += 1
            if w in sw:
                hits += 1
            continue
        ws = w.strip(_PUNCT)
        if not ws:
            continue
        # rare path: punctuation-adjacent or mixed tokens ("don't",
        # "word."); a per-char scan here is off the hot path
        if ws.isalpha() or any(c.isalpha() for c in ws):
            words += 1
            if ws in sw:
                hits += 1
    if not words:
        return 0.0
    return hits / words


def latin_ratio(text: str) -> float:
    """ASCII letters / (ASCII letters + non-ASCII chars) of the sample.

    A byte-level stand-in for "fraction of alphabetic chars that are
    Latin": non-ASCII chars in foreign-script text are almost all
    letters, and the rare accented Latin letter costs English/French/
    German prose only a few percent — far from the 0.85 gate."""
    b = _sample(text).encode("utf-8", "ignore")
    letters = len(b.translate(None, _DEL_NON_LETTER))
    non_ascii = len(b.translate(None, _DEL_NON_LEAD))
    total = letters + non_ascii
    if not total:
        return 0.0
    return letters / total


def is_english(text: str, min_stopword_ratio: float = 0.12,
               min_latin: float = 0.85) -> bool:
    """Accept pages that read like running English prose."""
    if latin_ratio(text) < min_latin:
        return False
    return english_score(text) >= min_stopword_ratio
