"""ExtractionService: background ingestion loop feeding the index.

Rebuild of the reference's src/index/extraction_service.rs:40-125 —
an endless loop that picks a WARC file, streams pages out of it, and
feeds the search service — with two deliberate changes:

- Pages are inserted in embed-batch-sized groups (one batched forward +
  one batched index add) instead of one ExtractedPage message each
  (extraction_service.rs:94-99 / search_service.rs:158-181, the
  reference's ingest-throughput ceiling).
- The WARC source is pluggable: `CommonCrawlSource` mirrors the
  reference (random file from the crawl's warc.paths.gz,
  extraction_service.rs:41-52, 60 s error backoff :54-57), while
  `LocalWarcSource` serves offline corpora and tests.

Port of dawnsearch_tpu/ingest/extraction_service.py, the same pipeline
and the same sources. The spawned extraction workers import only this
package's host modules (ingest/, utils/): neither torch nor CUDA is
loaded in them (tests/test_torch_ingest_parity.py checks it), so a
worker never creates a CUDA context on the node's card.
"""

from __future__ import annotations

import glob
import gzip
import io
import itertools
import os
import queue
import random
import threading
import time
from typing import Iterator

from dawnsearch_tpu_torch.ingest.pages import (MAX_TEXT, ExtractedPage,
                                               Stages, iter_pages)
from dawnsearch_tpu_torch.utils.logging import (METRICS, SPANS, span,
                                                span_args, service_logger,
                                                wait_span)

log = service_logger("Extraction")

CRAWL = "CC-MAIN-2023-23"  # extraction_service.rs:31-32
ERROR_BACKOFF_S = 60.0  # extraction_service.rs:54-57
BETWEEN_FILES_S = 10.0  # extraction_service.rs:58-59
QUERY_IDLE_S = 2.0  # no query this recently -> coalesce ingest batches


class WarcLedger:
    """Durable record of fully-ingested WARC files, so a restarted
    indexer never re-reads one. The reference's random pick
    (extraction_service.rs:52) happily re-downloads whole files and
    relies on per-URL dedup; recording completed files skips the
    download and the re-extraction outright."""

    def __init__(self, path: str):
        self.path = path
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self._seen = {line.rstrip("\n") for line in f if line.strip()}

    def seen(self, name: str) -> bool:
        with self._lock:
            return name in self._seen

    def mark(self, name: str) -> None:
        with self._lock:
            if name in self._seen:
                return
            self._seen.add(name)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(name + "\n")
                # a mark says "this file's pages are durably inserted";
                # it must not survive a crash its inserts did not
                f.flush()
                os.fsync(f.fileno())

    def __len__(self) -> int:
        with self._lock:
            return len(self._seen)


class LocalWarcSource:
    """Round-robin over local WARC files (offline corpora, tests)."""

    def __init__(self, pattern: str, loop: bool = False):
        self.pattern = pattern
        self.loop = loop

    @property
    def one_shot(self) -> bool:
        return not self.loop

    def files(self) -> Iterator[io.BufferedIOBase | str]:
        while True:
            paths = sorted(glob.glob(self.pattern))
            if not paths:
                return
            for p in paths:
                yield p
            if not self.loop:
                return

    def specs(self) -> Iterator[tuple[str, str]]:
        """(name, openable spec) pairs for worker-process extraction."""
        for p in self.files():
            yield p, p


class CommonCrawlSource:
    """Random WARC files from a Common Crawl listing
    (extraction_service.rs:41-52). Streams over HTTPS; in a zero-egress
    environment every fetch raises and the service backs off."""

    BASE_URL = "https://data.commoncrawl.org"

    def __init__(self, crawl: str = CRAWL, ledger=None,
                 base_url: str | None = None):
        self.crawl = crawl
        self.ledger = ledger  # skip fully-ingested WARCs at pick time
        self.base_url = base_url or self.BASE_URL  # overridable for stubs
        self._paths: list[str] | None = None

    def _listing(self) -> list[str]:
        if self._paths is None:
            import urllib.request
            url = f"{self.base_url}/crawl-data/{self.crawl}/warc.paths.gz"
            with urllib.request.urlopen(url, timeout=60) as r:
                self._paths = gzip.decompress(r.read()).decode().split()
            log.info("crawl %s: %d warc files", self.crawl, len(self._paths))
        return self._paths

    def files(self) -> Iterator[tuple[str, io.BufferedIOBase]]:
        import urllib.request
        for path, url in self.specs():
            log.info("streaming %s", url)
            yield path, io.BufferedReader(
                urllib.request.urlopen(url, timeout=120))

    def specs(self) -> Iterator[tuple[str, str]]:
        """(name, URL) pairs — worker processes open the stream
        themselves (ingest.sidecar.open_warc handles URLs)."""
        while True:
            paths = self._listing()
            if self.ledger is not None:
                fresh = [p for p in paths if not self.ledger.seen(p)]
                if not fresh:
                    log.info("every WARC in %s already ingested", self.crawl)
                    return
                paths = fresh
            path = random.choice(paths)  # random file (:52)
            yield path, f"{self.base_url}/{path}"


# the sums of pages.py::Stages, in the order of Stages.sums()
STAGE_COUNTERS = ("ingest_extract_read_s", "ingest_extract_decode_s",
                  "ingest_extract_html_s", "ingest_extract_filter_s",
                  "ingest_records_read", "ingest_pages_kept",
                  "ingest_extract_repaired", "ingest_text_truncated")


def _extract_worker(spec_q, out_q, batch_size: int, tracing=None,
                    max_text: int = MAX_TEXT) -> None:
    """Extraction worker process: WARC specs in, page-triple batches out.

    Runs torch-free (never touches a device) in its own interpreter, so
    its Python share stops serializing with the tokenize/insert threads
    on the parent's GIL. Module-level for spawn picklability. Messages
    out: ("batch", name, [(url, title, text), ...], meta) / ("done", name,
    None) when a file fully drained / ("error", name, repr) / ("exit",
    "", None) on the poison pill. A batch's meta holds its id ("pid.seq"),
    the sums of STAGE_COUNTERS since the last batch, and, while `tracing`
    (a multiprocessing.Event) was set as the batch began, its records'
    spans and the waits of its blocked puts on the wall clock."""
    from dawnsearch_tpu_torch.ingest.sidecar import open_warc
    pid, tid = os.getpid(), threading.get_native_id()
    thread = f"extract-worker-{pid}/extract"
    seq = itertools.count()
    st = Stages()

    def begin() -> None:
        st.reset()
        st.spans = [] if tracing is not None and tracing.is_set() else None

    def ship(name: str, batch: list) -> None:
        meta = {"id": f"{pid}.{next(seq)}", "pid": pid, "tid": tid,
                "thread": thread, "spans": st.spans, "stages": st.sums()}
        begin()
        w0 = time.time_ns()
        out_q.put(("batch", name, batch, meta))
        if st.spans is not None:  # ships with the next batch
            st.spans.append(("extract.blocked", w0, time.time_ns(),
                             {"batch": meta["id"]}, "b"))

    begin()
    while True:
        spec = spec_q.get()
        if spec is None:
            out_q.put(("exit", "", None))
            return
        name, opener = spec
        try:
            _, src = open_warc(opener)
            batch: list[tuple[str, str, str]] = []
            for page in iter_pages(src, st, max_text):
                batch.append((page.url, page.title, page.text))
                if len(batch) >= batch_size:
                    ship(name, batch)
                    batch = []
            if batch:
                ship(name, batch)
            out_q.put(("done", name, None))
        except Exception as e:  # ship the error, keep the worker alive
            out_q.put(("error", name, repr(e)))


class ExtractionService:
    """Three-stage pipeline: the extraction thread parses WARC records
    and fills a bounded queue of page batches; the tokenize thread
    pre-tokenizes each batch (the C++ WordPiece tokenizer releases the
    GIL, so this genuinely overlaps both neighbors); the insert thread
    drains ready batches into embed+index. Host-side extraction and
    tokenization of batches i+1/i+2 overlap the device work of batch i
    (the reference does everything serially, one page at a time).

    `workers > 0` moves extraction into that many subprocesses (for
    sources exposing specs(): local globs, Common Crawl URLs) — the
    lever against the extraction thread's GIL share on long production
    runs; each worker pays interpreter+import startup, so short runs
    (tests) keep the in-thread default."""

    def __init__(self, service, source=None, batch_size: int = 64,
                 max_pages: int | None = None,
                 ledger: WarcLedger | None = None,
                 between_files_s: float | None = None,
                 workers: int = 0,
                 rate_limit: float = 0.0,
                 coalesce_max: int | None = None,
                 query_idle_s: float | None = None,
                 max_text: int = MAX_TEXT,
                 insert_tokens: int | None = None):
        self.service = service
        self.max_text = max_text  # characters of a page's text kept
        self.source = source if source is not None else CommonCrawlSource()
        self.batch_size = batch_size
        # pages/s ceiling (0 = unlimited). Ingest shares the chip with
        # queries; each insert batch occupies the device for its encode,
        # so unthrottled bulk ingest sets query tail latency;
        # latency-sensitive mixed deployments set this to bound
        # ingest's device occupancy instead of shrinking batch size.
        self.rate_limit = rate_limit
        self.workers = workers if hasattr(
            self.source, "specs") else 0  # stream-only sources stay in-thread
        self.max_pages = max_pages  # stop after N (tests); None = forever
        self.ledger = ledger  # completed-WARC record (restart-safe ingest)
        # pause between WARC files (extraction_service.rs:58-59); local
        # sources don't need to be polite to a remote CDN
        if between_files_s is None:
            between_files_s = (0.0 if isinstance(source, LocalWarcSource)
                               else BETWEEN_FILES_S)
        self.between_files_s = between_files_s
        # Adaptive insert coalescing: when extraction runs ahead (a
        # batch is already waiting in _ready) AND no query dispatched in
        # the last QUERY_IDLE_S, the insert thread merges waiting
        # batches up to coalesce_max pages into ONE insert_pages call,
        # amortizing the fixed per-batch cost of a standalone backfill.
        # Under live query load the recency gate keeps batches at
        # batch_size, so one ingest encode holds the device no longer
        # than that (config.py ingest_batch_size). None = auto: TWO
        # fused-ingest bucket caps, so
        # insert_pages' one-deep sub-batch pipeline (dispatch i+1
        # before readback i) engages; 0 disables.
        if coalesce_max is None:
            coalesce_max = 2 * (getattr(service, "max_ingest_batch", None)
                                or 0)
        self.coalesce_max = max(int(coalesce_max), 0)
        # ... and by work: the real tokens an insert batch may hold (the
        # encoder's insert_tokens, a few dispatches of a large model; None
        # where only pages count). A pre-tokenized batch past it is cut
        # into inserts that each keep under it (or hold one page).
        self.insert_tokens = insert_tokens
        # recency window for the coalescing gate (config
        # ingest_query_idle_s)
        self.query_idle_s = (QUERY_IDLE_S if query_idle_s is None
                             else float(query_idle_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tokenize_thread: threading.Thread | None = None
        self._insert_thread: threading.Thread | None = None
        # depth 8 (~8 MB of page text at the shipped batch size): deep
        # enough that a full coalesce window (2x the 1024 bucket cap =
        # 4 batches) can be waiting while 4 more stage behind it
        self._batches: "queue.Queue" = queue.Queue(maxsize=8)
        self._ready: "queue.Queue" = queue.Queue(maxsize=8)
        self.pages_ingested = 0

    def start(self) -> "ExtractionService":
        self._insert_thread = threading.Thread(
            target=self._insert_loop, daemon=True, name="extraction-insert")
        self._insert_thread.start()
        self._tokenize_thread = threading.Thread(
            target=self._tokenize_loop, daemon=True,
            name="extraction-tokenize")
        self._tokenize_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="extraction")
        self._thread.start()
        return self

    def stop(self) -> None:
        # Every producer put goes through _put_batch (bounded, checks
        # _stop) and the rate-limit pace sleep is _stop.wait, so
        # setting the event reliably unblocks the whole pipeline: the
        # extraction thread can't be stuck in a full-queue put when the
        # sentinel goes in behind it.
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._batches.put(None)  # tokenize loop forwards the sentinel
        if self._tokenize_thread is not None:
            self._tokenize_thread.join(timeout=10.0)
        if self._insert_thread is not None:
            self._insert_thread.join(timeout=10.0)

    def join(self, timeout: float | None = None) -> None:
        """Wait until extraction AND inserts drain (tests/one-shot
        runs). The timeout bounds the WHOLE wait — queue.Queue.join()
        has no deadline, so a wedged insert (a hung device) would
        otherwise hang callers despite their timeout argument."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        if self._thread is not None:
            self._thread.join(timeout)
        for q in (self._batches, self._ready):
            with q.all_tasks_done:
                while q.unfinished_tasks:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        return
                    q.all_tasks_done.wait(remaining)

    def _tokenize_loop(self) -> None:
        """Queue protocol (through _batches -> here -> _ready):
        ("batch", name, pages, batch ids) / ("mark", name, None, ()) /
        None sentinel. Ledger marks RIDE THE PIPELINE behind their file's
        batches, so a WARC is recorded as ingested only after its pages
        are durably inserted — not merely extracted (a dropped insert
        batch or a crash between extract and insert must not lose pages
        forever)."""
        tokenize = getattr(self.service, "tokenize_pages", None)
        while True:
            with wait_span("ingest.tokenize.wait"):
                item = self._batches.get()
            if item is None:
                self._ready.put(None)
                self._batches.task_done()
                return
            kind, name, batch, bids = item
            if kind == "mark":
                with wait_span("ingest.tokenize.put"):
                    self._ready.put(("mark", name, None, None, ()))
                self._batches.task_done()
                continue
            # in-thread batches carry ExtractedPage; worker batches
            # already ship (url, title, text) triples
            triples = (batch if batch and isinstance(batch[0], tuple)
                       else [(p.url, p.title, p.text) for p in batch])
            token_ids = None
            if callable(tokenize):
                try:
                    with span("ingest.tokenize", batches=bids,
                              pages=len(triples)), \
                            METRICS.timer("ingest_tokenize"):
                        token_ids = tokenize(triples)
                except Exception:
                    log.exception("tokenize batch failed; inserting raw")
            # put BEFORE task_done so _batches.join() implies everything
            # extracted is visible to _ready.join()
            with wait_span("ingest.tokenize.put", batches=bids):
                self._ready.put(("batch", name, triples, token_ids, bids))
            self._batches.task_done()

    def _queries_recent(self) -> bool:
        t = getattr(self.service, "last_query_monotonic", None)
        return t is not None and (time.monotonic() - t) < self.query_idle_s

    def _insert_loop(self) -> None:
        """Every moment of this thread is in one of its spans while a
        capture runs (ingest.insert.wait, ingest.coalesce, then those of
        _insert and insert_pages), and no span covers a whole batch: a
        device-idle gap is named by what the thread was doing in it."""
        failed: set[str] = set()  # files with a dropped insert batch
        pending = None  # item pulled mid-coalesce, handled next turn
        while True:
            if pending is not None:
                item, pending = pending, None
            else:
                with span("ingest.insert.wait"):
                    t0 = time.perf_counter()
                    item = self._ready.get()
                    METRICS.inc("ingest_insert_wait_s",
                                time.perf_counter() - t0)
            if item is None:
                self._ready.task_done()
                return
            kind, name, triples, token_ids, bids = item
            owed = 1  # task_done() calls this turn (1 per merged item)
            names = {name}
            tokens = (sum(map(len, token_ids)) if token_ids is not None
                      else 0)
            if kind == "batch" and self.coalesce_max > len(triples):
                # merge already-waiting batches into one dispatch while
                # the chip is query-idle (rationale at coalesce_max)
                with span("ingest.coalesce"):
                    while (len(triples) < self.coalesce_max
                           and not self._queries_recent()):
                        try:
                            nxt = self._ready.get_nowait()
                        except queue.Empty:
                            break
                        more = (sum(map(len, nxt[3]))
                                if nxt is not None and nxt[0] == "batch"
                                and nxt[3] is not None else 0)
                        if (nxt is None or nxt[0] != "batch"
                                or (nxt[3] is None) != (token_ids is None)
                                or len(triples) + len(nxt[2])
                                > self.coalesce_max
                                or (self.insert_tokens is not None
                                    and tokens + more > self.insert_tokens)):
                            pending = nxt  # sentinel/mark/oversize: next
                            break
                        owed += 1
                        triples = triples + nxt[2]
                        tokens += more
                        if token_ids is not None:
                            token_ids = token_ids + nxt[3]
                        bids = bids + nxt[4]
                        names.add(nxt[1])
            try:
                with span_args(batches=bids):
                    if kind == "mark":
                        with span("ingest.mark"):
                            self._mark(name, failed)
                    else:
                        for lo, hi in self._cuts(token_ids, len(triples)):
                            self._insert(triples[lo:hi], None
                                         if token_ids is None
                                         else token_ids[lo:hi])
            except Exception:
                log.exception("insert batch failed")
                failed.update(names)
            finally:
                for _ in range(owed):
                    self._ready.task_done()

    def _cuts(self, token_ids: list[list[int]] | None, n: int
              ) -> list[tuple[int, int]]:
        """[lo, hi) ranges of a batch's n pages, in order, each an insert
        of at most insert_tokens real tokens (or one page); the whole
        batch where no token limit applies."""
        if token_ids is None or self.insert_tokens is None:
            return [(0, n)]
        out, lo, acc = [], 0, 0
        for i, ids in enumerate(token_ids):
            if i > lo and acc + len(ids) > self.insert_tokens:
                out.append((lo, i))
                lo, acc = i, 0
            acc += len(ids)
        out.append((lo, n))
        return out

    def _mark(self, name: str, failed: set[str]) -> None:
        if name in failed:
            log.warning("not marking %s ingested: an insert batch failed "
                        "(will re-ingest on restart)", name)
        elif self.ledger is not None and name:
            self.ledger.mark(name)

    def _insert(self, triples: list[tuple[str, str, str]],
                token_ids: list[list[int]] | None) -> None:
        if self.rate_limit > 0:
            # pace so the rolling rate stays under the ceiling; sleeping
            # BEFORE the insert keeps the device idle window in front of
            # the dispatch, where queries can use it
            min_interval = len(triples) / self.rate_limit
            last = getattr(self, "_last_insert_t", 0.0)
            wait = last + min_interval - time.perf_counter()
            if wait > 0:
                # interruptible: a low rate ceiling with the shipped
                # batch size can mean a 20+ s pace sleep, and stop()
                # must not strand the insert thread past its join
                # (it still inserts this batch after waking — the
                # file's ledger mark rides behind it)
                with span("ingest.pace"):
                    self._stop.wait(wait)
            self._last_insert_t = time.perf_counter()
        t0 = time.perf_counter()
        # kwargs only when pre-tokenized, so duck-typed test services
        # with the plain insert_pages(pages) signature keep working
        kw = {"token_ids": token_ids} if token_ids is not None else {}
        self.service.insert_pages(triples, **kw)
        dt = time.perf_counter() - t0
        METRICS.observe("ingest_insert", dt)
        self.pages_ingested += len(triples)
        METRICS.inc("pages_extracted", len(triples))
        # throughput meter like the reference's (warc.rs:107-114)
        log.info("ingested %d pages in %.2fs (%.1f pages/s, total %d)",
                 len(triples), dt, len(triples) / max(dt, 1e-9),
                 self.pages_ingested)

    @staticmethod
    def _named(item) -> tuple[str, "io.BufferedIOBase | str"]:
        """Sources yield paths, streams, or (name, stream) pairs."""
        if isinstance(item, tuple):
            return item
        if isinstance(item, str):
            return item, item
        return getattr(item, "name", "") or repr(item), item

    def _run_workers(self) -> None:
        """Worker-pool extraction: feed specs, collect batches."""
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        # BOUNDED: CommonCrawlSource.specs() is an infinite random
        # picker with no I/O between yields — an unbounded queue would
        # be filled at CPU speed (unbounded RSS, massive duplication)
        spec_q = ctx.Queue(maxsize=self.workers * 2)
        out_q = ctx.Queue(maxsize=self.workers * 4)
        tracing = ctx.Event()  # set while a profile capture runs
        SPANS.share(tracing)
        METRICS.gauge("ingest_workers", self.workers)
        procs = [ctx.Process(target=_extract_worker,
                             args=(spec_q, out_q, self.batch_size, tracing,
                                   self.max_text),
                             daemon=True, name=f"extract-worker-{i}")
                 for i in range(self.workers)]
        for p in procs:
            p.start()
        stop_feed = threading.Event()

        def put_spec(item) -> bool:
            while not (stop_feed.is_set() or self._stop.is_set()):
                try:
                    spec_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def feed():
            inflight: set[str] = set()  # random picker repeats names
            for name, spec in self.source.specs():
                if stop_feed.is_set() or self._stop.is_set():
                    break
                if name in inflight or (self.ledger is not None
                                        and self.ledger.seen(name)):
                    continue
                if not put_spec((name, spec)):
                    break
                inflight.add(name)
            for _ in procs:
                if not put_spec(None):
                    break

        threading.Thread(target=feed, daemon=True,
                         name="extract-feed").start()
        produced = 0
        live = len(procs)
        partial: set[str] = set()  # files cut short by max_pages
        try:
            while live and not self._stop.is_set():
                try:
                    with wait_span("extract.collect.wait"):
                        msg = out_q.get(timeout=5.0)
                except queue.Empty:
                    # a hard-killed worker (OOM, unguarded __main__ in
                    # an embedding script) never sends "exit" — don't
                    # hang the service on it
                    if not any(p.is_alive() for p in procs):
                        log.warning("extraction workers died without "
                                    "exit messages; stopping")
                        break
                    continue
                kind, name, payload = msg[:3]
                if kind == "exit":
                    live -= 1
                elif kind == "error":
                    log.warning("worker extraction error on %s: %s",
                                name, payload)
                elif kind == "done":
                    if name and name not in partial:
                        # ledger mark rides BEHIND the file's batches;
                        # the insert thread commits it post-insert
                        with wait_span("extract.collect.put"):
                            if not self._put_batch(("mark", name, None,
                                                    ())):
                                break
                elif kind == "batch":
                    meta = msg[3]
                    METRICS.inc_many(dict(zip(STAGE_COUNTERS,
                                              meta["stages"])))
                    if meta["spans"]:
                        SPANS.extend(meta["pid"], meta["tid"],
                                     meta["thread"], meta["spans"])
                    if self.max_pages is not None:
                        room = self.max_pages - produced
                        if room <= 0:
                            partial.add(name)
                            continue
                        if len(payload) > room:
                            payload = payload[:room]
                            partial.add(name)
                    produced += len(payload)
                    with wait_span("extract.collect.put",
                                   batches=[meta["id"]]):
                        if not self._put_batch(("batch", name, payload,
                                                [meta["id"]])):
                            break
                    if self.max_pages is not None \
                            and produced >= self.max_pages:
                        break
        finally:
            SPANS.unshare(tracing)
            stop_feed.set()
            for p in procs:  # extraction-only processes: safe to kill
                p.terminate()
            for p in procs:
                p.join(timeout=5.0)

    def _put_batch(self, item) -> bool:
        """Bounded put into the pipeline: keeps checking _stop so the
        extraction thread can never deadlock on a full queue after
        stop() (which joins it with a timeout and then sends the
        sentinel). False = stopping; the item is dropped, which is the
        safe direction — its file's ledger mark is dropped with it, so
        a restart re-ingests the file."""
        while not self._stop.is_set():
            try:
                self._batches.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        if self.workers > 0:
            self._run_workers()
            return
        # Ledger marks land asynchronously (post-insert), so an endless
        # random-pick source could re-choose a file whose mark is still
        # in the pipeline — dedup by name within this process.
        inflight: set[str] = set()
        bids = (f"{os.getpid()}.{i}" for i in itertools.count())
        # Pages ENQUEUED across files — the max_pages budget. (The
        # insert thread's pages_ingested lags this by the queue depth,
        # and counting both double-counted the current file's pages, so
        # the service stopped as much as 2x early.)
        total = 0
        st = Stages()

        def count_stages() -> None:  # as the workers' batches do
            METRICS.inc_many(dict(zip(STAGE_COUNTERS, st.sums())))
            st.reset()

        while not self._stop.is_set():
            try:
                progressed = False
                for item in self.source.files():
                    name, f = self._named(item)
                    # (without a ledger an endless random source keeps
                    # re-ingesting by design — reference semantics)
                    if self.ledger is not None and (
                            name in inflight or self.ledger.seen(name)):
                        log.debug("skipping already-ingested %s", name)
                        if hasattr(f, "close"):
                            f.close()  # sources that pre-open streams
                        # pace the re-pick: when every remaining file is
                        # inflight-but-unmarked, an endless random
                        # source would otherwise re-open streams in a
                        # tight loop until the async mark commits
                        if self._stop.wait(
                                0 if self.max_pages else
                                min(self.between_files_s, 1.0)):
                            return
                        continue
                    progressed = True
                    batch: list[ExtractedPage] = []
                    drained = True  # stayed true -> whole file consumed
                    t_batch = time.perf_counter()
                    for page in iter_pages(f, st, self.max_text):
                        if self._stop.is_set():
                            return
                        batch.append(page)
                        if self.max_pages is not None and \
                                total + len(batch) >= self.max_pages:
                            drained = False  # budget reached mid-file
                            break
                        if len(batch) >= self.batch_size:
                            # extraction-stage time per batch (excludes
                            # any stall inside _put_batch) — the ingest
                            # per-stage breakdown (/api/metrics)
                            METRICS.observe("ingest_extract",
                                            time.perf_counter() - t_batch)
                            count_stages()
                            total += len(batch)
                            if not self._put_batch(("batch", name, batch,
                                                    [next(bids)])):
                                return
                            batch = []
                            t_batch = time.perf_counter()
                    count_stages()
                    if self.max_pages is not None:
                        batch = batch[: self.max_pages - total]
                    if batch:
                        total += len(batch)
                        if not self._put_batch(("batch", name, batch,
                                                [next(bids)])):
                            return
                    if drained and name:
                        # recorded by the insert thread AFTER the file's
                        # batches are durably inserted (a dropped batch
                        # must not lose its pages forever)
                        inflight.add(name)
                        if not self._put_batch(("mark", name, None, ())):
                            return
                    if self.max_pages is not None \
                            and total >= self.max_pages:
                        return
                    if self._stop.wait(
                            0 if self.max_pages else self.between_files_s):
                        return
                if not progressed:
                    return  # source exhausted: nothing left to do
                if self.max_pages is None and getattr(
                        self.source, "one_shot", False):
                    return  # finite source fully drained
            except Exception as e:
                log.warning("ingestion error: %s; backing off %.0fs",
                            e, ERROR_BACKOFF_S)
                if self._stop.wait(ERROR_BACKOFF_S):
                    return
