"""The bytes path of HTML extraction: a WARC record's body goes to (title,
text) in one native pass (native/extract.cpp::dawn_extract_page, through
ingest/native.py::extract_page and ingest/pages.py::iter_pages).

- The UTF-8 pass (dawn_utf8_clean) drops what Python's
  bytes.decode("utf-8", errors="ignore") drops, on seeded byte strings of
  valid, invalid, truncated and surrogate sequences and NULs.
- Markup soup (tags, attributes, named, numeric and surrogate entities,
  invalid UTF-8, NULs, script and style, comments, stray '<'): the pass
  gives what the string path gives for the body decoded with
  errors="ignore": the JAX package's native/extract.cpp, the tag-by-tag
  extractor whose output the one-pass parser keeps byte for byte, and
  the port's own dawn_extract (links mode) alike.
- Documents of well-formed markup with the same hazards in their text:
  the pass gives extract.py::extract's answer, the Python tier's. (On
  soup the two tiers differ and always did: the Python tier decodes every
  HTML5 entity and remaps numeric ones, counts characters where the C++
  counts bytes, and follows html.parser's recovery rules.)
- iter_pages over a WARC file of the benchmark's pages in all five
  scripts (benchmark/texts.py::Pages), a third of the bodies carrying
  invalid bytes: the native and the Python tier, and the JAX package,
  give the same triples, the pages the generator says the node keeps,
  and the same record, kept and repaired counts; the extraction service
  counts the repaired bodies in-process and from a spawned worker.
"""

import ctypes

import numpy as np
import pytest

from benchmark import texts
from dawnsearch_tpu.ingest import native as ref_native
from dawnsearch_tpu.ingest import pages as ref_pages
from dawnsearch_tpu_torch.ingest import native, pages
from dawnsearch_tpu_torch.ingest.extract import extract as py_extract
from dawnsearch_tpu_torch.ingest.extraction_service import (
    ExtractionService, LocalWarcSource)
from dawnsearch_tpu_torch.ingest.warc import write_warc
from dawnsearch_tpu_torch.utils import nativelib
from dawnsearch_tpu_torch.utils.logging import METRICS

SEEDS = range(8)
INVALID = [b"\xff", b"\xfe", b"\x80", b"\xbf", b"\xc0\x80", b"\xc1\xbf",
           b"\xe2\x82", b"\xe0\x80\x80", b"\xe0\x9f\xbf", b"\xed\xa0\x80",
           b"\xed\xbf\xbf", b"\xf0\x8f\xbf\xbf", b"\xf4\x90\x80\x80",
           b"\xf5\x80\x80\x80", b"\xf0\x9f\x98", b"\xc3"]
VALID = [b"a", b" ", b"\x00", b"\x7f", b"\xc3\xa9", b"\xdf\xbf",
         b"\xe0\xa0\x80", b"\xe4\xb8\xad", b"\xed\x9f\xbf", b"\xee\x80\x80",
         b"\xf0\x90\x80\x80", b"\xf0\x9f\x98\x80", b"\xf4\x8f\xbf\xbf"]
SOUP = [b"<p>", b"</p>", b"<div class='x'>", b"</div>", b"<P CLASS=y>",
        b"<a href=\"/x&amp;y\">", b"<a HREF=bare>", b"<a href=''>",
        b"<a href='&#0;'>", b"<a href=\"&#xD800;z\" href=two>", b"</a>",
        b"<title>", b"</title>", b"<head>", b"</head>", b"<nav>", b"</nav>",
        b"<footer>", b"</footer>", b"<li>", b"<h1>", b"<td>", b"<table>",
        b"<blockquote>", b"<br/>", b"<p / class=x>", b"<img alt='b>c'>",
        b"<script>var a='<p>x</p>';</script>", b"<style>p{}</style>",
        b"<SCRIPT>", b"</SCRIPT >", b"</scriptx>", b"<!-- c <p>h</p> -->",
        b"<!DOCTYPE html>", b"<?xml x?>", b"<", b"</", b"< x", b"</x-y>",
        b"<\xc3\xa9>", b"<p\x00>", b"&amp;", b"&lt;", b"&gt;", b"&quot;",
        b"&apos;", b"&nbsp;", b"&copy;", b"&zzq;", b"&;", b"&#;", b"&",
        b"&#65;", b"&#x42;", b"&#0;", b"&#xD800;", b"&#xDFFF;", b"&#x110000;",
        b"&#128512;", b"&#-5;", b"&#x0x41;", b"&#1234567890;", b"\x1e",
        b" ", b"\n\t", b"word ", b"lighthouse keeper ", b"\xe4\xb8\xad"
        ] + INVALID + VALID
WORDS = [b"lighthouse", b"keeper", b"storm", b"harbour", b"the", b"of", b"a",
         b"sea"]
# hazards in well-formed documents' text, on which the two tiers agree
HAZARDS = [b"&amp;", b"&lt;", b"&gt;", b"&quot;", b"&#65;", b"&#x42;",
           b"\n\t", b"  ", b"< x", b"\x00"] + INVALID
BLOCKS = [b"p", b"div", b"li", b"td", b"h1", b"blockquote", b"section"]
BOILER = [b"nav", b"footer", b"aside", b"form"]


def _clean(data: bytes) -> bytes:
    lib = nativelib.get()
    out = ctypes.create_string_buffer(len(data))
    n = lib.dawn_utf8_clean(data, len(data), out)
    return out.raw[:n]


def _invalid(data: bytes) -> bool:
    try:
        data.decode("utf-8")
    except UnicodeDecodeError:
        return True
    return False


def _soup(rng: np.random.Generator, alphabet: list, n: int) -> bytes:
    return b"".join(alphabet[k] for k in rng.integers(0, len(alphabet), n))


def _text(rng: np.random.Generator, n: int) -> bytes:
    return b"".join((HAZARDS[rng.integers(len(HAZARDS))]
                     if rng.random() < 0.25 else
                     WORDS[rng.integers(len(WORDS))]) + b" "
                    for _ in range(n))


def _document(rng: np.random.Generator) -> bytes:
    """A page of well-formed markup: a title, blocks of text with links,
    boilerplate, script, style and comments; hazards inside the text."""
    out = [b"<!DOCTYPE html><html>"]
    if rng.random() < 0.8:
        out += [b"<head><title>", _text(rng, int(rng.integers(0, 8))),
                b"</title><style>p{color:red}</style></head>"]
    out.append(b"<body>")
    for _ in range(int(rng.integers(0, 12))):
        r = rng.random()
        if r < 0.1:
            out.append(b"<script>var a = '<p>x</p>';</script>")
        elif r < 0.15:
            out.append(b"<!-- <p>hidden</p> -->")
        elif r < 0.25:
            tag = BOILER[rng.integers(len(BOILER))]
            out += [b"<", tag, b">", _text(rng, 5), b"</", tag, b">"]
        elif r < 0.3:
            out.append(b"<br/><img src='a.png' alt='b>c'>")
        else:
            tag = BLOCKS[rng.integers(len(BLOCKS))]
            out += [b"<", tag, b" class='c'>",
                    _text(rng, int(rng.integers(0, 30)))]
            if rng.random() < 0.5:
                out += [b"<a href=\"/x?a=1&amp;b=2\">",
                        _text(rng, int(rng.integers(1, 10))), b"</a>",
                        _text(rng, int(rng.integers(0, 5)))]
            if rng.random() < 0.8:
                out += [b"</", tag, b">"]
    out.append(b"</body></html>")
    return b"".join(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_utf8_pass_matches_python(seed):
    rng = np.random.default_rng([seed, 1])
    pieces = INVALID + VALID + [bytes([b]) for b in range(256)]
    for _ in range(300):
        data = _soup(rng, pieces, int(rng.integers(0, 60)))
        if rng.random() < 0.3:  # long ASCII runs: the word-at-a-time path
            data = b"x" * int(rng.integers(0, 40)) + data + b"y" * 17
        assert _clean(data) == data.decode("utf-8", "ignore").encode(), data
        assert native.extract_page(data)[2] == _invalid(data), data


@pytest.mark.parametrize("seed", SEEDS)
def test_page_bytes_match_the_frozen_string_path(seed):
    assert nativelib.get() is not None and ref_native.available()
    rng = np.random.default_rng([seed, 2])
    for _ in range(250):
        body = _soup(rng, SOUP, int(rng.integers(1, 200)))
        html = body.decode("utf-8", "ignore")
        want = ref_native.extract(html)
        assert native.extract_page(body) == (want.title, want.text,
                                             _invalid(body)), body
        got = native.extract(html)
        assert (got.title, got.text, got.links) == (
            want.title, want.text, want.links), body


@pytest.mark.parametrize("seed", SEEDS)
def test_page_bytes_match_the_python_tier(seed, monkeypatch):
    rng = np.random.default_rng([seed, 3])
    bodies = [_document(rng) for _ in range(200)]
    got = [native.extract_page(b) for b in bodies]
    monkeypatch.setattr(nativelib, "get", lambda: None)
    for body, page in zip(bodies, got):
        want = py_extract(body.decode("utf-8", "ignore"))
        assert page == (want.title, want.text, _invalid(body)), body
        assert native.extract_page(body) == page, body


def _pages_warc(path: str, seed: int = 11, n: int = 60) -> tuple:
    """n pages of texts.Pages in all five scripts, every third body with
    invalid bytes put between two ASCII bytes; the Pages, and the number
    of such bodies."""
    corpus = texts.Pages(seed, n, {k: 0.2 for k in texts.LANGUAGES},
                         text_mean_chars=1500, text_sigma=0.6,
                         html_mean_bytes=9000, html_sigma=0.5,
                         html_max_bytes=30000)
    rng = np.random.default_rng(seed)
    records, repaired = [], 0
    for i in range(n):
        body = corpus.html(i).encode()
        if i % 3 == 0:
            ascii_ = np.frombuffer(body, np.uint8) < 0x80
            at = np.flatnonzero(ascii_[:-1] & ascii_[1:]) + 1
            for k in np.sort(rng.choice(at, 4, replace=False))[::-1]:
                body = body[:k] + INVALID[rng.integers(len(INVALID))] \
                    + body[k:]
            repaired += 1
        records.append((corpus.url(i), body))
    write_warc(path, records)
    return corpus, repaired


def _run(path: str) -> tuple:
    st = pages.Stages()
    triples = [(p.url, p.title, p.text) for p in pages.iter_pages(path, st)]
    return triples, (st.records, st.kept, st.repaired)


def test_iter_pages_bytes_path_matches_python(tmp_path, monkeypatch):
    path = str(tmp_path / "pages.warc.gz")
    corpus, repaired = _pages_warc(path)
    assert {corpus.language(i) for i in range(corpus.n)} == \
        set(texts.LANGUAGES)
    got, counts = _run(path)
    ref = [(p.url, p.title, p.text) for p in ref_pages.iter_pages(path)]
    want = [corpus.stored(i) for i in np.flatnonzero(corpus.kept())]
    assert len(want) >= 5
    assert got == ref == want
    assert counts == (corpus.n, len(want), repaired)
    monkeypatch.setattr(nativelib, "get", lambda: None)
    assert native.readers()["extract"] == "python"
    assert _run(path) == (got, counts)


@pytest.mark.parametrize("workers", [0, 1])
def test_repaired_bodies_reach_metrics(tmp_path, workers):
    path = str(tmp_path / "pages.warc.gz")
    corpus, repaired = _pages_warc(path, seed=12, n=30)

    class Sink:
        def __init__(self):
            self.pages = []

        def insert_pages(self, batch, from_network=False):
            self.pages += batch
            return list(range(len(batch)))

    before = METRICS.snapshot()
    sink = Sink()
    ex = ExtractionService(sink, source=LocalWarcSource(path),
                           batch_size=4, workers=workers)
    assert ex.workers == workers
    ex.start()
    ex.join(timeout=120)
    ex.stop()
    after = METRICS.snapshot()
    rise = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("ingest_extract_repaired", "ingest_records_read",
                      "ingest_pages_kept")}
    assert rise == {"ingest_extract_repaired": repaired,
                    "ingest_records_read": corpus.n,
                    "ingest_pages_kept": int(corpus.kept().sum())}
    assert len(sink.pages) == int(corpus.kept().sum())
