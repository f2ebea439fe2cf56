"""Ingestion: WARC streaming + filters, extraction (py vs C++), language
filter, end-to-end extraction service feeding a provider.
The port's copy of tests/test_ingest.py.
"""

import gzip
import hashlib

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.ingest import native
from dawnsearch_tpu_torch.ingest.extract import extract as py_extract
from dawnsearch_tpu_torch.ingest.extraction_service import (
    ExtractionService, LocalWarcSource)
from dawnsearch_tpu_torch.ingest.lang import english_score, is_english
from dawnsearch_tpu_torch.ingest.pages import iter_pages
from dawnsearch_tpu_torch.ingest.warc import iter_warc_records, write_warc

torch.set_num_threads(2)

ENGLISH = ("The history of the lighthouse is a story of the sea and of the "
           "people who kept the light burning through every storm. It was "
           "built on the rocks by hand, and for more than a century it has "
           "guided the ships that pass in the night along this coast. ") * 4

GERMAN = ("Die Geschichte des Leuchtturms ist eine Geschichte des Meeres "
          "und der Menschen, die das Licht durch jeden Sturm am Brennen "
          "hielten. Er wurde von Hand auf den Felsen gebaut und weist seit "
          "mehr als einem Jahrhundert den Schiffen den Weg. ") * 4


def page_html(title, body):
    return (f"<html><head><title>{title}</title></head><body>"
            f"<nav><a href='/a'>A</a> <a href='/b'>B</a></nav>"
            f"<article><p>{body}</p></article>"
            f"<footer>contact us</footer></body></html>").encode()


WARC_RECORDS = [
    ("https://good.example/story", page_html("Lighthouse", ENGLISH)),
    ("https://short.example/x", page_html("Tiny", "too short")),
    ("https://german.example/de", page_html("Leuchtturm", GERMAN)),
    ("https://query.example/page?id=3", page_html("Query", ENGLISH)),
    ("https://good.example/second", page_html("Second story", ENGLISH)),
]


@pytest.fixture
def warc_file(tmp_path):
    p = str(tmp_path / "test.warc.gz")
    write_warc(p, WARC_RECORDS)
    return p


def test_warc_filters(warc_file):
    recs = list(iter_warc_records(warc_file))
    urls = [r.url for r in recs]
    # '?' URL dropped at WARC level (page_source.rs:73-75); 'short' body
    # survives here (>=500 B of HTML) and dies at the text filter later.
    assert "https://query.example/page?id=3" not in urls
    assert "https://good.example/story" in urls
    for r in recs:
        assert not r.body.startswith(b"HTTP/")  # envelope stripped


def test_warc_plain_and_gz(tmp_path):
    records = [("https://a.example/x", page_html("T", ENGLISH))]
    for name in ("plain.warc", "zipped.warc.gz"):
        p = str(tmp_path / name)
        write_warc(p, records)
        assert len(list(iter_warc_records(p))) == 1


def test_iter_pages_filters(warc_file):
    pages = list(iter_pages(warc_file))
    urls = [p.url for p in pages]
    assert urls == ["https://good.example/story",
                    "https://good.example/second"]
    page = pages[0]
    assert page.title == "Lighthouse"
    assert len(page.text) <= 2048  # page_source.rs:113
    assert "lighthouse is a story of the sea" in page.text
    assert "contact us" not in page.text  # footer stripped
    assert page.combined.startswith("Lighthouse\n")


def test_wet_conversion_records(tmp_path):
    p = str(tmp_path / "f.warc.gz")
    write_warc(p, [("https://wet.example/a", ENGLISH.encode())],
               warc_type="conversion", payload_type="text/plain")
    pages = list(iter_pages(p))
    assert len(pages) == 1 and pages[0].title == ""
    assert pages[0].text.startswith("The history of the lighthouse")


def test_unidentified_payload_records_are_skipped(tmp_path):
    """Response records with NO WARC-Identified-Payload-Type fall back
    to the record content-type ("application/http..."), which must not
    pass the filter — it would wave images/PDFs into the HTML extractor
    (round-3 review; the reference skips unidentified records too,
    page_source.rs:68)."""
    import gzip
    body = (b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n\r\n"
            + page_html("Unidentified", ENGLISH))
    head = (f"WARC/1.0\r\n"
            f"WARC-Type: response\r\n"
            f"WARC-Target-URI: https://x.example/a\r\n"
            f"Content-Type: application/http; msgtype=response\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode()
    p = str(tmp_path / "noid.warc.gz")
    with gzip.open(p, "wb") as f:
        f.write(head + body + b"\r\n\r\n")
    assert list(iter_pages(p)) == []


def test_language_filter():
    assert is_english(ENGLISH)
    assert not is_english(GERMAN)
    assert not is_english("数字 " * 300)
    assert english_score("") == 0.0


def test_language_filter_number_heavy_english():
    """Numbers/dates/prices must not deflate the stopword denominator:
    a stats-heavy English page is still English (english_score counts
    only letter-bearing words)."""
    stats = ("The score was 42 to 17 on 2023-06-12 and the price " +
             "rose to $13.50, up 3.2% from 11.08 in the last 14 days. ") * 20
    assert is_english(stats)
    # punctuation-adjacent words still count ("don't" is a word,
    # "---" and "3.5" are not)
    assert english_score("don't stop the music, it's the best") > 0.2
    assert english_score("12 34 --- 5.6 ... 78") == 0.0


def test_native_matches_python(warc_file):
    if not native.available():
        pytest.skip("native library not built")
    for rec in iter_warc_records(warc_file):
        html = rec.body.decode("utf-8", errors="ignore")
        a, b = py_extract(html), native.extract(html)
        assert a.title == b.title
        assert a.text == b.text
        assert a.links == b.links


EDGE_CASES = [
    "",
    "no tags at all just text " * 10,
    "<p>unclosed paragraph " + "words " * 30,
    "<P CLASS='x'>UPPER CASE TAGS</P><p>" + "content words here " * 5,
    "<script>var a = '<p>fake</p>';</script><p>" + "real text " * 10,
    "<a href=bare>linktext</a><p>" + "plain body text " * 10,
    "<p>entity &amp; &lt;tag&gt; &#65;&#x42; test " + "pad " * 10,
    "<!-- comment <p>hidden</p> --><p>" + "visible words " * 10,
    "<br><br/><td>cell one here words</td><td>cell two also words</td>",
]


def test_native_matches_python_edge_cases():
    if not native.available():
        pytest.skip("native library not built")
    for html in EDGE_CASES:
        a, b = py_extract(html), native.extract(html)
        assert a.title == b.title, html
        assert a.text == b.text, html
        assert a.links == b.links, html


@pytest.mark.parametrize("body", [c.encode() for c in EDGE_CASES]
                         + [body for _, body in WARC_RECORDS])
def test_page_bytes_match_python(body):
    """The pipeline's bytes entry (native.extract_page) against the
    Python tier on the decoded body."""
    assert native.available()
    want = py_extract(body.decode("utf-8", errors="ignore"))
    assert native.extract_page(body) == (want.title, want.text, False)


class FakeService:
    """Captures insert batches like SearchService.insert_pages."""

    def __init__(self):
        self.batches = []

    def insert_pages(self, pages, from_network=False):
        self.batches.append(list(pages))
        return list(range(len(pages)))


def test_extraction_service_batches(tmp_path):
    records = [(f"https://n.example/{i}",
                page_html(f"Story {i}", ENGLISH)) for i in range(7)]
    p = str(tmp_path / "batch.warc.gz")
    write_warc(p, records)
    svc = FakeService()
    ex = ExtractionService(svc, source=LocalWarcSource(p), batch_size=3)
    ex.start()
    ex.join(timeout=30)
    total = sum(len(b) for b in svc.batches)
    assert total == 7
    assert [len(b) for b in svc.batches] == [3, 3, 1]  # batched, not 1-by-1
    assert svc.batches[0][0][0] == "https://n.example/0"


def test_extraction_service_worker_pool(tmp_path):
    """workers>0: extraction runs in subprocesses; every page arrives,
    fully-drained files hit the ledger, and a restart skips them."""
    from dawnsearch_tpu_torch.ingest.extraction_service import WarcLedger

    for f in range(3):
        records = [(f"https://w.example/{f}/{i}",
                    page_html(f"Doc {f}-{i}", ENGLISH)) for i in range(5)]
        write_warc(str(tmp_path / f"w{f}.warc.gz"), records)
    ledger = WarcLedger(str(tmp_path / "ledger.txt"))
    svc = FakeService()
    ex = ExtractionService(svc, source=LocalWarcSource(
        str(tmp_path / "w*.warc.gz")), batch_size=4, ledger=ledger,
        workers=2)
    assert ex.workers == 2
    ex.start()
    ex.join(timeout=120)
    ex.stop()
    urls = {p[0] for b in svc.batches for p in b}
    assert len(urls) == 15
    assert len(ledger) == 3  # every file fully drained -> marked

    # restart: everything already ledgered, nothing re-extracted
    svc2 = FakeService()
    ex2 = ExtractionService(svc2, source=LocalWarcSource(
        str(tmp_path / "w*.warc.gz")), batch_size=4, ledger=ledger,
        workers=2)
    ex2.start()
    ex2.join(timeout=120)
    ex2.stop()
    assert svc2.batches == []


def test_insert_coalescing_when_query_idle(tmp_path):
    """With the chip query-idle and extraction running ahead, the
    insert thread merges waiting batches up to the service's
    max_ingest_batch — one fused dispatch per ~2x pages (the BENCH_r03
    ingest regression fix). Service duck-type: max_ingest_batch set,
    no recent last_query_monotonic."""
    import time as _time

    class SlowService(FakeService):
        max_ingest_batch = 8

        def insert_pages(self, pages, from_network=False, token_ids=None):
            _time.sleep(0.05)  # insert slower than extraction -> backlog
            return super().insert_pages(pages, from_network)

    records = [(f"https://co.example/{i}",
                page_html(f"Story {i}", ENGLISH)) for i in range(24)]
    p = str(tmp_path / "co.warc.gz")
    write_warc(p, records)
    svc = SlowService()
    ex = ExtractionService(svc, source=LocalWarcSource(p), batch_size=2)
    assert ex.coalesce_max == 16  # auto: 2x the service's bucket cap
    ex.start()
    ex.join(timeout=30)
    assert sum(len(b) for b in svc.batches) == 24
    assert max(len(b) for b in svc.batches) > 2  # coalescing engaged
    assert max(len(b) for b in svc.batches) <= 16  # ...bounded
    # order preserved under coalescing
    flat = [page[0] for b in svc.batches for page in b]
    assert flat == [f"https://co.example/{i}" for i in range(24)]


def test_insert_coalescing_gated_by_recent_queries(tmp_path):
    """A recent query dispatch (last_query_monotonic fresh) suppresses
    coalescing: batches stay at batch_size so queries interleave
    between small ingest dispatches (the round-3 soak latency trade)."""
    import time as _time

    class BusyService(FakeService):
        max_ingest_batch = 8

        def insert_pages(self, pages, from_network=False, token_ids=None):
            self.last_query_monotonic = _time.monotonic()  # live queries
            _time.sleep(0.05)
            return super().insert_pages(pages, from_network)

    records = [(f"https://busy.example/{i}",
                page_html(f"Story {i}", ENGLISH)) for i in range(24)]
    p = str(tmp_path / "busy.warc.gz")
    write_warc(p, records)
    svc = BusyService()
    svc.last_query_monotonic = _time.monotonic()
    ex = ExtractionService(svc, source=LocalWarcSource(p), batch_size=2)
    ex.start()
    ex.join(timeout=30)
    assert sum(len(b) for b in svc.batches) == 24
    assert max(len(b) for b in svc.batches) == 2  # never coalesced


def test_extraction_service_end_to_end(tmp_path):
    """WARC -> extract -> embed -> index -> search, full pipeline."""
    from dawnsearch_tpu_torch.index.provider import SearchProvider
    from dawnsearch_tpu_torch.serving.search_service import SearchService

    class HashBatcher:
        def embed_many(self, texts):
            out = []
            for t in texts:
                seed = int.from_bytes(
                    hashlib.md5(t.encode()).digest()[:4], "little")
                v = np.random.default_rng(seed).standard_normal(384)
                out.append((v / np.linalg.norm(v)).astype(np.float32))
            return np.stack(out)

        def embed(self, text):
            return self.embed_many([text])[0]

    records = [(f"https://e2e.example/{i}",
                page_html(f"Chapter {i}", ENGLISH + f" chapter {i}"))
               for i in range(4)]
    p = str(tmp_path / "e2e.warc.gz")
    write_warc(p, records)
    provider = SearchProvider(data_dir=None, verify_on_load=False, device="cpu")
    service = SearchService(provider, HashBatcher(), instance_id="n")
    ex = ExtractionService(service, source=LocalWarcSource(p), batch_size=2)
    ex.start()
    ex.join(timeout=30)
    assert len(provider.store) == 4
    page = provider.store.get(1)
    assert page is not None and page[0].title == "Chapter 0"
    res = service.text_search(service.provider.store.get(2)[0].title + "\n"
                              + provider.store.get(2)[0].text,
                              search_remote=False)
    assert res.pages[0].page_id == 2


def test_extraction_rate_limit_paces_inserts(tmp_path):
    """rate_limit bounds pages/s: 60 pages at 200 pages/s must take
    >= ~0.25 s (unthrottled this corpus inserts in milliseconds)."""
    import time as _time

    records = [(f"https://rl.example/{i}",
                page_html(f"Story {i}", ENGLISH)) for i in range(60)]
    p = str(tmp_path / "rl.warc.gz")
    write_warc(p, records)
    svc = FakeService()
    ex = ExtractionService(svc, source=LocalWarcSource(p), batch_size=20,
                           rate_limit=200.0)
    t0 = _time.perf_counter()
    ex.start()
    ex.join(timeout=30)
    dt = _time.perf_counter() - t0
    assert sum(len(b) for b in svc.batches) == 60
    # first batch unpaced, then 2 paced gaps of 0.1 s each
    assert dt >= 0.18, dt
