"""Coalescing batchers: concurrent requests -> one device call.

The reference's embedding actor serves exactly one text per message over
a depth-2 channel (the reference's src/embedding/embedding_service.rs:142-167,
bin/dawnsearch.rs:59), so concurrent searches serialize through the
model — and its index serves one query per call (search_provider.rs:214).
Here a worker thread drains whatever requests accumulated — up to
`max_batch`, waiting at most `max_wait_ms` after the first — and runs
ONE batched device call for all of them. Latency under load drops from
O(queue) device calls to O(1). The same machinery batches the encoder
forward (EmbeddingBatcher) and local index searches (SearchBatcher).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np

from dawnsearch_tpu_torch.utils.logging import (METRICS, SPANS, service_logger,
                                                span_args)

log = service_logger("Batcher")


class CoalescingBatcher:
    """Generic request coalescing: submit(payload) -> Future[result],
    where `process_fn(payloads) -> results` handles a whole batch.

    While a profile capture runs, each request gets an id, its time from
    submit until this thread takes it is the wait `<name>.wait` (on the
    submitting thread), and every span opened while its batch is
    processed carries the batch's ids as `requests`."""

    def __init__(self, process_fn: Callable[[list], Sequence],
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 name: str = "batcher"):
        self._process = process_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.name = name
        self._ids = itertools.count(1)
        self._q: queue.Queue = queue.Queue()
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, payload) -> Future:
        if self._shutdown.is_set():
            raise RuntimeError(f"{self.name} is shut down")
        fut: Future = Future()
        stamp = None
        if SPANS.on:
            stamp = (next(self._ids), time.time_ns(),
                     threading.get_native_id())
        self._q.put((payload, fut, stamp))
        return fut

    def _taken(self, item) -> None:
        stamp = item[2]
        if stamp is not None:
            SPANS.record(f"{self.name}.wait", stamp[1], time.time_ns(),
                         tid=stamp[2], request=stamp[0])

    def _run(self) -> None:
        while not self._shutdown.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            self._taken(first)
            batch = [first]
            self._collect_and_process(batch)
        # Drain: requests still queued when the sentinel was consumed
        # (or racing submit()'s shutdown check) must be FAILED promptly,
        # not left to hang their callers for the full future timeout
        # (round-3 review).
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[1].done():
                item[1].set_exception(
                    RuntimeError(f"{self.name} shut down"))

    def _collect_and_process(self, batch: list) -> None:
        t0 = time.monotonic()
        while len(batch) < self.max_batch:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self._shutdown.set()
                break
            self._taken(item)
            batch.append(item)
        try:
            with span_args(requests=[s[0] for _, _, s in batch if s]):
                results = self._process([p for p, _, _ in batch])
            for (_, fut, _), r in zip(batch, results):
                fut.set_result(r)
            METRICS.inc(f"{self.name}_batches", 1)
            METRICS.inc(f"{self.name}_items", len(batch))
        except Exception as e:  # propagate to every waiter
            for _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(e)

    def stop(self) -> None:
        self._shutdown.set()
        self._q.put(None)
        self._thread.join(timeout=5.0)
        # a submit() racing the shutdown check can enqueue after the
        # worker's drain; sweep once more on this thread
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(
                    RuntimeError(f"{self.name} shut down"))


class EmbeddingBatcher(CoalescingBatcher):
    def __init__(
        self,
        encode_fn: Callable[[Sequence[str]], np.ndarray],
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        documents_fn: Callable[[Sequence[str]], np.ndarray] | None = None,
    ):
        self._encode = encode_fn
        # page texts (embed_many) may take another prompt than queries
        self._documents = documents_fn or encode_fn
        super().__init__(self._process_texts, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, name="embed")

    def _process_texts(self, texts: list[str]) -> np.ndarray:
        return self._encode(texts)

    def embed(self, text: str, timeout: float | None = 30.0) -> np.ndarray:
        """Blocking single-text embed (coalesced under the hood)."""
        return self.embed_async(text).result(timeout=timeout)

    def embed_async(self, text: str) -> "Future[np.ndarray]":
        return self.submit(text)

    def embed_many(self, texts: Sequence[str],
                   timeout: float | None = 60.0) -> np.ndarray:
        """Batch entry point for ingestion — bypasses the queue, one call."""
        return self._documents(list(texts))


class SearchBatcher(CoalescingBatcher):
    """Coalesce concurrent per-request index searches into one batched
    provider call (the provider's search is batched end-to-end; one
    (B, N) matmul serves B waiting requests)."""

    def __init__(self, search_fn: Callable[[np.ndarray, int], list],
                 max_batch: int = 64, max_wait_ms: float = 3.0):
        self._search = search_fn
        super().__init__(self._process, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, name="search")

    BATCH_BUCKETS = (1, 8, 32, 64, 128)

    def _process(self, payloads: list) -> list:
        # payloads: (embedding, k); group by k (usually all equal)
        by_k: dict[int, list[int]] = {}
        for idx, (_, k) in enumerate(payloads):
            by_k.setdefault(k, []).append(idx)
        results: list = [None] * len(payloads)
        for k, idxs in by_k.items():
            embs = np.stack([payloads[i][0] for i in idxs])
            # pad to a bucketed batch size: the search program compiles
            # once per (B, k) shape, so B must come from a small grid
            n = len(idxs)
            bucket = next((b for b in self.BATCH_BUCKETS if b >= n), n)
            if bucket > n:
                embs = np.concatenate(
                    [embs, np.repeat(embs[:1], bucket - n, axis=0)])
            batch_results = self._search(embs, k)
            for i, r in zip(idxs, batch_results[:n]):
                results[i] = r
        return results

    def search(self, embedding: np.ndarray, k: int,
               timeout: float | None = 30.0):
        return self.submit((embedding, k)).result(timeout=timeout)
