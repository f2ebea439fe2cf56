"""SearchService: the search orchestrator.

Rebuild of the reference's SearchService actor
(the reference's src/search/search_service.rs:45-277). Message variants
become methods (the actor mailbox was a Rust necessity; here the
provider and batcher are internally synchronized):

- TextSearch            -> text_search()        (search_service.rs:60-81)
- EmbeddingSearch       -> embedding_search()   (search_service.rs:83-104)
- MoreLikeSearch        -> more_like_search()   (search_service.rs:105-157)
- ExtractedPage         -> insert_pages()       (search_service.rs:158-181)
- Stats / GetEmbedding / Save / Shutdown -> same names
                                            (search_service.rs:182-196)

The remote fan-out contract matches search_remote
(search_service.rs:201-277): seed a BestResults(k) with local hits, use
its worst distance as the network distance_limit, merge whatever the
remote backend returned by its deadline, count pages/instances.
`remote` is any object with search()/replicate()/fetch_embedding() —
the UDP P2P service implements it; None means single-node.

Port of dawnsearch_tpu/serving/search_service.py. The fused paths are
chosen by testing the provider's index against this package's FlatIndex
and ShardedFlatIndex (serving/fused.py), so a port index never falls back
to the split path unnoticed. Text queries to a sharded index go through
the provider's search_dispatch (FusedQueryPath is flat-only, as in the
reference).
"""

from __future__ import annotations

import threading
import time
from typing import Protocol, Sequence

import numpy as np

from dawnsearch_tpu_torch.index.provider import FoundPage, SearchProvider, SearchResult
from dawnsearch_tpu_torch.ops.topk import BestResults
from dawnsearch_tpu_torch.serving.fused import (FusedIngestPath,
                                                FusedQueryPath,
                                                ShardedFusedIngestPath,
                                                holding)
from dawnsearch_tpu_torch.utils.logging import METRICS, span


class RemoteBackend(Protocol):
    """What the P2P layer provides (reference: UdpMsg::Search /
    Insert / GetEmbedding, udp_service.rs:108-124)."""

    def search(self, embedding: np.ndarray, distance_limit: float | None,
               k: int) -> tuple[list[FoundPage], int, int]:
        """-> (pages, pages_searched, instances_contacted); returns at
        its deadline with whatever arrived (udp_service.rs:297-341)."""
        ...

    def replicate(self, url: str, title: str, text: str) -> None:
        """Fire-and-forget insert replication (udp_service.rs:376-394)."""
        ...

    def fetch_embedding(self, instance_id: str, page_id: int
                        ) -> np.ndarray | None:
        """Remote GetEmbedding round-trip (udp_service.rs:254-283)."""
        ...


class SearchService:
    def __init__(
        self,
        provider: SearchProvider,
        batcher,  # EmbeddingBatcher (duck-typed for tests)
        encoder=None,  # SentenceEncoder behind the fused paths
        instance_id: str = "",
        k: int = 20,
        remote: RemoteBackend | None = None,
    ):
        self.provider = provider
        self.batcher = batcher
        self.instance_id = instance_id
        self.k = k
        self.remote = remote
        # monotonic stamp of the last local query dispatch (every query
        # funnels through _fused_text_batch or _local_search_batch);
        # the ingest pipeline reads it to decide whether the chip is
        # contended — coalesce big idle-time ingest dispatches, keep
        # them small under live query load
        self.last_query_monotonic = 0.0
        # Two-lock split (the reference's never-block-search actor
        # model, dawnsearch.rs:64-78, rebuilt for async device dispatch):
        # - _lock guards the DEVICE index state (buffer references +
        #   count) and is held only while work is being ENQUEUED —
        #   CUDA launches are async, so the expensive part (device
        #   execution + host readback) happens outside it. Ingest
        #   writes and growth change the buffers and count, which is why
        #   searches must also enqueue under it. It is the
        #   PROVIDER's reentrant device_lock so the provider's own index
        #   mutations (store-recovery rollback/rebuild) stay race-free
        #   even when called outside the service's hold.
        # - _ingest_lock serializes whole ingest batches end-to-end
        #   (screen -> dispatch -> readback -> store) so the device-row
        #   = store-row contract holds, WITHOUT making queries wait for
        #   a batch's device execution.
        #   It is the PROVIDER's ingest_gate when available, so a
        #   snapshot save (which captures buffer references and reads
        #   them back outside the device lock) mutually excludes the
        #   in-place ingest writes that would change them.
        self._lock = getattr(provider, "device_lock", None) \
            or threading.RLock()
        self._ingest_lock = getattr(provider, "ingest_gate", None) \
            or threading.Lock()
        from dawnsearch_tpu_torch.serving.batcher import (
            CoalescingBatcher, SearchBatcher)
        # Concurrent requests' local searches coalesce into one batched
        # provider call — one (B, N) device program serves B waiters
        # (the reference searches one query per FFI call,
        # search_provider.rs:214).
        self._search_batcher = SearchBatcher(self._local_search_batch)
        # Text queries take the FUSED path when possible: tokenize ->
        # encoder -> index top-k as ONE device program per coalesced
        # batch (serving/fused.py), halving dispatches per query round.
        self._fused = None
        self._text_batcher = None
        self._warm_buckets: set = set()  # (k, fused) buckets seen once
        self._fused_ingest = None
        if encoder is not None and hasattr(encoder, "tokenize_texts"):
            if FusedQueryPath.supports(provider.index):
                self._fused = FusedQueryPath(encoder, provider.index)
                self._text_batcher = CoalescingBatcher(
                    self._fused_text_batch, name="text_query")
            if FusedIngestPath.supports(provider.index):
                self._fused_ingest = FusedIngestPath(encoder, provider.index)
            elif ShardedFusedIngestPath.supports(provider.index):
                self._fused_ingest = ShardedFusedIngestPath(
                    encoder, provider.index)

    # -- queries ------------------------------------------------------------

    def text_search(self, query: str, k: int | None = None,
                    search_remote: bool = True) -> SearchResult:
        """Embed the query, then search (search_service.rs:60-81); fused
        single-dispatch path when the index supports it."""
        k = k or self.k
        if self._text_batcher is not None:
            # Timeout covers first-use work (the CUDA kernel build on a
            # fresh checkout), then drops to the steady-state bound once
            # this bucket has served.
            key = (k, self._fused is not None)
            timeout = 60.0 if key in self._warm_buckets else 240.0
            emb, local = self._text_batcher.submit((query, k)).result(
                timeout=timeout)
            self._warm_buckets.add(key)
            if not search_remote or self.remote is None:
                return local
            return self._merge_remote(emb, local, k)
        emb = self.batcher.embed(query)
        return self.embedding_search(emb, k=k, search_remote=search_remote)

    def _fused_text_batch(self, payloads: list) -> list:
        """(text, k) payloads -> [(embedding, local SearchResult)]."""
        self.last_query_monotonic = time.monotonic()
        by_k: dict[int, list[int]] = {}
        for idx, (_, k) in enumerate(payloads):
            by_k.setdefault(k, []).append(idx)
        out: list = [None] * len(payloads)
        for k, idxs in by_k.items():
            texts = [payloads[i][0] for i in idxs]
            prov = self.provider
            # shared fetch-width policy (overfetch + i4 ladder;
            # device-rerank indexes come back pre-ranked)
            k_fetch = prov.fetch_width(k)
            # Lock only around dispatch; the execution wait (readback),
            # store-side re-rank and metadata join run outside it so an
            # in-flight ingest batch can enqueue between queries.
            with holding(self._lock, "query.lock.wait"), \
                    span("query.dispatch", queries=len(texts)):
                emb_d, d_d, i_d, k_eff = self._fused.dispatch(
                    texts, k_fetch)
            with span("query.finalize"):
                embs, d, row_ids = self._fused.finalize(
                    emb_d, d_d, i_d, len(texts), k_fetch, k_eff)
            if k_fetch > k:  # exact f32 re-rank (same as split path)
                with span("query.rerank"):
                    d, row_ids = prov._rerank_f32(embs, d, row_ids, k)
            with span("query.join"):
                results = prov.results_from_ids(d, row_ids,
                                                self.instance_id)
            for i, emb, res in zip(idxs, embs, results):
                out[i] = (emb, res)
        return out

    def _local_search_batch(self, embeddings: np.ndarray, k: int
                            ) -> list[SearchResult]:
        self.last_query_monotonic = time.monotonic()
        # dispatch_lock: the device lock covers only program enqueue;
        # execution wait + re-rank + store join run outside it (same
        # tail contract as the fused text path — UDP-served searches
        # and more-like-this go through here)
        return self.provider.search_embeddings(
            embeddings, k=k, instance_id=self.instance_id,
            dispatch_lock=self._lock)

    def embedding_search(self, embedding: np.ndarray, k: int | None = None,
                         search_remote: bool = True) -> SearchResult:
        """Local top-k (coalesced across concurrent requests), then merge
        remote peers under the deadline (search_service.rs:83-104,
        201-277)."""
        k = k or self.k
        local = self._search_batcher.search(np.asarray(embedding), k)
        if not search_remote or self.remote is None:
            return local
        return self._merge_remote(np.asarray(embedding), local, k)

    def _merge_remote(self, embedding: np.ndarray, local: SearchResult,
                      k: int) -> SearchResult:
        """Fan out to peers and merge under the deadline
        (search_service.rs:201-277)."""
        best: BestResults[FoundPage] = BestResults(k)
        for p in local.pages:
            best.insert((self.instance_id, p.page_id), p.distance, p)
        limit = best.worst_distance() if len(best) == k else None
        pages, searched, contacted = self.remote.search(embedding, limit, k)
        for p in pages:
            best.insert((p.instance_id, p.page_id), p.distance, p)
        METRICS.inc("remote_merges", 1)
        return SearchResult(
            pages=[payload for _, _, payload in best.sorted()],
            pages_searched=local.pages_searched + searched,
            instances_contacted=1 + contacted)

    def more_like_search(self, instance_id: str, page_id: int,
                         k: int | None = None) -> SearchResult | None:
        """Explore-similar: reuse the page's stored embedding. Local pages
        read the store; remote ones need a GetEmbedding round-trip
        (search_service.rs:105-157)."""
        if instance_id in ("", self.instance_id):
            emb = self.provider.embedding_for_page(page_id)
        elif self.remote is not None:
            emb = self.remote.fetch_embedding(instance_id, page_id)
        else:
            emb = None
        if emb is None:
            return None
        return self.embedding_search(emb, k=k)

    def get_embedding(self, text: str) -> np.ndarray:
        """SearchMsg::GetEmbedding (search_service.rs:185-188)."""
        return self.batcher.embed(text)

    # -- ingestion ------------------------------------------------------------

    @property
    def max_ingest_batch(self) -> int | None:
        """Largest page batch one fused-ingest dispatch accepts (the
        encoder's top batch bucket); None when only the split path
        exists. The extraction pipeline coalesces idle-time batches up
        to this size to amortize the per-dispatch cost."""
        fi = self._fused_ingest
        return fi.max_batch if fi is not None else None

    @staticmethod
    def _combined(pages: Sequence[tuple[str, str, str]]) -> list[str]:
        """The text the service embeds for a page (title + body — the
        reference's page.combined, page_source.rs:44-50)."""
        return [f"{title}\n{text}" for _, title, text in pages]

    def tokenize_pages(self, pages: Sequence[tuple[str, str, str]]
                       ) -> list[list[int]] | None:
        """Pre-tokenize (url, title, text) triples for
        `insert_pages(token_ids=...)` — lets an ingest pipeline run the
        tokenizer on its own thread, overlapped with WARC extraction and
        device work, instead of serializing it under the provider lock.
        None when no encoder-backed fused path exists (the split path
        re-tokenizes internally anyway)."""
        if self._fused_ingest is None:
            return None
        enc = self._fused_ingest.encoder
        return enc.tokenize_texts(self._combined(pages), enc.document_prompt)

    def insert_pages(self, pages: Sequence[tuple[str, str, str]],
                     from_network: bool = False,
                     token_ids: list[list[int]] | None = None
                     ) -> list[int | None]:
        """Batch-embed and insert (url, title, text) triples; locally
        originated pages replicate to the network
        (search_service.rs:158-181). The reference embeds one page per
        message — batching here is the ingest-throughput fix.
        `token_ids` (from tokenize_pages) skips in-lock tokenization."""
        if not pages:
            return []
        urls = [p[0] for p in pages]
        titles = [p[1] for p in pages]
        texts = [p[2] for p in pages]
        if self._fused_ingest is not None:
            # The ingest loop (IngestPath.run) holds the device-state lock
            # only while each sub-batch is enqueued; finish reads it back
            # and stores it outside that lock, so concurrent queries
            # dispatch between sub-batches. store_pages gets the device-row
            # base taken at dispatch: the pipelined loop has already
            # moved len(index) past it. Index rows land before their store
            # rows commit (up to two sub-batches ahead); results_from_ids
            # drops ids the store can't join yet, so a query racing an
            # insert simply doesn't see the newest sub-batches (the
            # reference's actor mailbox has the same insert-then-search
            # ordering, dawnsearch.rs:64-78). The screen's, readback's and
            # store's seconds are counters, and each step is a span while a
            # profile capture runs.
            with holding(self._ingest_lock, "ingest.lock.wait"):
                with span("ingest.screen", pages=len(urls)):
                    t0 = time.perf_counter()
                    keep = self.provider.screen(urls)
                    METRICS.inc("ingest_screen_s", time.perf_counter() - t0)
                kept = [i for i, ok in enumerate(keep) if ok]
                ids = [None] * len(pages)
                if token_ids is None and kept:  # the kept pages' ids
                    token_ids = dict(zip(kept, self.tokenize_pages(
                        [pages[i] for i in kept])))

                def finish(sub, emb_dev, base, part):
                    with span("ingest.readback", pages=len(sub),
                              part=part):
                        t0 = time.perf_counter()
                        embs = emb_dev[: len(sub)].cpu().numpy()
                        dt = time.perf_counter() - t0
                        METRICS.observe("fused_ingest", dt)
                        METRICS.inc("ingest_readback_s", dt)
                    with span("ingest.store", pages=len(sub), part=part):
                        t0 = time.perf_counter()
                        stored = self.provider.store_pages(
                            [urls[i] for i in sub],
                            [titles[i] for i in sub],
                            [texts[i] for i in sub], embs, base=base)
                        METRICS.inc("ingest_store_s",
                                    time.perf_counter() - t0)
                    for i, sid in zip(sub, stored):
                        ids[i] = sid

                self._fused_ingest.run(token_ids, kept, self._lock, finish)
        else:
            embs = self.batcher.embed_many(self._combined(pages))
            # LOCK ORDER: ingest gate strictly OUTSIDE the device lock,
            # everywhere (provider.insert_pages takes gate->device
            # itself; save() takes gate->device) — taking the device
            # lock first here deadlocks against a concurrent autosave.
            with self._ingest_lock, self._lock:
                ids = self.provider.insert_pages(urls, titles, texts, embs)
        if not from_network and self.remote is not None:
            for (url, title, text), pid in zip(pages, ids):
                if pid is not None:
                    self.remote.replicate(url, title, text)
        return ids

    # -- admin ------------------------------------------------------------

    def stats(self) -> dict:
        s = self.provider.stats()
        s["instance_id"] = self.instance_id
        return s

    def save(self) -> None:
        # the provider takes the (shared, reentrant) device lock only
        # around its reference capture; the readback + disk write run
        # outside so queries keep dispatching during the autosave
        self.provider.save()

    def shutdown(self) -> None:
        """Save and release (search_service.rs:190-196). NOT under
        self._lock: provider.save/close lock what they need, and
        holding the device lock here while store_pages' recovery path
        (store lock held) waits for it would deadlock the node on
        SIGTERM (lock-order inversion)."""
        if self._text_batcher is not None:
            self._text_batcher.stop()
        self._search_batcher.stop()
        self.provider.shutdown()
