"""SearchProvider: durable page store + device index + save/load/verify.

Rebuild of the reference's SearchProvider
(the reference's src/search/search_provider.rs): owns the SQLite store
(source of truth) and the device-resident index, enforces the page cap
and duplicate-URL skip on insert (search_provider.rs:164-166, 254-263),
rebuilds the index from the store on startup when no snapshot exists
(search_provider.rs:111-153), and verifies stored embeddings
(search_provider.rs:289-327).

Batching departure: the reference inserts and searches one item at a
time; every entry point here is batched, because single-row device
round-trips waste the device.

Port of dawnsearch_tpu/index/provider.py: the same locking discipline
and store/index contract. Index writes land in place in the port's
FlatIndex (there is no buffer donation), and snapshot reloads go through
this package's own loader (dawnsearch_tpu_torch.index.load_index).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Sequence

import numpy as np

from dawnsearch_tpu_torch.index.flat import FlatIndex
from dawnsearch_tpu_torch.index.store import PageStore
from dawnsearch_tpu_torch.ops.quant import i4_fetch_width
from dawnsearch_tpu_torch.utils.logging import METRICS, service_logger

log = service_logger("SearchProvider")

INDEX_FILE = "index.dawn.npz"  # reference: index.usearch
DB_FILE = "pages.sqlite"
# The reference node's store (search_provider.rs:81). Same schema
# modulo column affinity, so a node pointed at a reference data_dir
# adopts it in place and rebuilds the device index from it — the
# switching path for existing reference deployments (doc/migration.md).
REFERENCE_DB_FILE = "dawnsearch.sqlite"


@dataclasses.dataclass
class FoundPage:
    """One search hit (reference search_provider.rs:51-61)."""
    page_id: int
    distance: float
    url: str
    title: str
    text: str
    instance_id: str = ""


@dataclasses.dataclass
class SearchResult:
    """Hits + scan stats surfaced in the UI (web.rs:318-323)."""
    pages: list[FoundPage]
    pages_searched: int
    instances_contacted: int = 1


class SearchProvider:
    def __init__(
        self,
        data_dir: str | None = None,
        dim: int = 384,
        index_dtype: str = "i8",
        max_pages: int = 1_000_000,  # reference cap (search_provider.rs:164-166)
        index_factory=None,
        verify_on_load: bool = True,
        rerank: int = 30,
        *,
        device,
    ):
        self.data_dir = data_dir
        self.max_pages = max_pages
        self.dim = dim
        # Device-state lock: guards the index buffer references and count
        # (growth swaps the buffers; a search must enqueue against one
        # consistent set).
        # SearchService shares THIS lock for its dispatch-only critical
        # sections; the provider itself takes it around its own index
        # mutations so the rare store-recovery paths are race-free even
        # though the service calls store_pages outside the lock.
        # Reentrant: insert_pages runs both under the service's hold and
        # standalone.
        self.device_lock = threading.RLock()
        # Ingest gate: held by WRITING mutators (index.add / fused
        # ingest writes) for their whole operation and by save() across
        # its readback+write. Writes land in place, so a snapshot's
        # captured buffers are only consistent while no write runs — but
        # searches never write, so they keep flowing during a save (the
        # 10-min autosave must not stall queries). Reentrant:
        # the store-recovery path re-enters insert_pages under it.
        # SearchService aliases its batch-serializing _ingest_lock to
        # THIS lock so the fused ingest paths are covered too.
        self.ingest_gate = threading.RLock()
        # Quantized indexes retrieve k+rerank candidates and re-rank them
        # with the store's exact f32 embeddings (SURVEY §7 hard parts:
        # "re-ranking top candidates at f32") — candidate ORDER becomes
        # exact; only candidates the i8 scan missed entirely stay missed.
        # 0 disables.
        self.rerank = rerank
        if data_dir is None:
            db_path = ":memory:"
        else:
            db_path = os.path.join(data_dir, DB_FILE)
            ref_db = os.path.join(data_dir, REFERENCE_DB_FILE)
            if not os.path.exists(db_path) and os.path.exists(ref_db):
                log.info("adopting reference store %s (the device index "
                         "rebuilds from it; index.usearch is ignored)",
                         ref_db)
                db_path = ref_db
        self.store = PageStore(db_path, dim=dim)
        try:
            self._init_index(index_factory, data_dir, dim, index_dtype,
                             max_pages, verify_on_load, device)
        except BaseException:
            # The constructor raising (contiguity refusal, cap guard,
            # corrupt store) must not strand the just-opened SQLite
            # connection and its WAL sidecars — retry loops would
            # accumulate handles on the adopted file.
            self.store.close()
            raise

    def _init_index(self, index_factory, data_dir, dim, index_dtype,
                    max_pages, verify_on_load, device) -> None:
        if index_factory is None:
            def index_factory():
                return FlatIndex(dim=dim, dtype=index_dtype,
                                 max_capacity=max_pages, device=device)
            index_factory.load_kwargs = {"max_capacity": max_pages,
                                         "device": device}
        make_index = index_factory
        self._make_index = make_index
        index_path = (None if data_dir is None
                      else os.path.join(data_dir, INDEX_FILE))
        self.index_path = index_path
        loaded = False
        if index_path and os.path.exists(index_path):
            try:
                from dawnsearch_tpu_torch.index import load_index
                # Snapshots store data, not policy: reload re-applies
                # the factory's configuration (max_capacity/exact/device)
                # or a restarted node silently loses its cap semantics.
                # Factories advertise it via .load_kwargs — a dict, or a
                # callable evaluated only here.
                lk = getattr(make_index, "load_kwargs", None)
                lk = dict(lk() if callable(lk) else (lk or {}))
                self.index = load_index(index_path, **lk)
                loaded = len(self.index) == len(self.store)
                if not loaded:
                    log.warning("index snapshot stale (%d rows vs %d pages); "
                                "rebuilding", len(self.index), len(self.store))
            except Exception as e:  # corrupt snapshot -> rebuild (robustness)
                log.warning("failed to load index snapshot: %s; rebuilding", e)
                loaded = False
        if not loaded:
            self.index = make_index()
            self._fill_index_from_db()
        if verify_on_load:
            n = self.store.verify()
            log.info("verified %d stored embeddings", n)

    def _fill_index_from_db(self) -> None:
        """Rebuild device index from SQLite (search_provider.rs:127-153)."""
        t0 = time.perf_counter()
        n = 0
        expected = self.store.max_id()  # ids are 1-based and contiguous
        if expected > self.max_pages:
            # Without this guard the rebuild dies mid-fill on the
            # index's own "index full" ValueError with no hint that the
            # cap is configuration, not corruption — exactly on the
            # large adopted deployments the migration path targets.
            raise ValueError(
                f"store holds {expected} pages but max_pages="
                f"{self.max_pages}; raise max_pages in the config to "
                "serve this store")
        for ids, embs in self.store.iter_embeddings():
            # Contract: device row r = insertion order (0-based); sqlite
            # rowids are the same order 1-based, so store_id = row_id + 1.
            # An adopted store with id gaps would silently break every
            # join downstream — refuse loudly and point at the fix.
            if len(ids) and (ids[0] != n + 1 or ids[-1] != n + len(ids)):
                raise ValueError(
                    f"store ids are not contiguous from 1 (got "
                    f"{ids[0]}..{ids[-1]} where {n + 1}.."
                    f"{n + len(ids)} was expected); run "
                    "`python -m dawnsearch_tpu_torch migrate --data-dir "
                    f"{self.data_dir}` to compact the store")
            self.index.add(embs)
            n += len(ids)
        if n:
            log.info("rebuilt index: %d vectors in %.2fs (expected %d)",
                     n, time.perf_counter() - t0, expected)

    # -- inserts ----------------------------------------------------------

    def insert_pages(
        self,
        urls: Sequence[str],
        titles: Sequence[str],
        texts: Sequence[str],
        embeddings: np.ndarray,
    ) -> list[int | None]:
        """Batched insert. Returns per-page store id or None if skipped
        (duplicate URL / capacity, search_provider.rs:164-166, 254-263).

        The whole batch stores in one SQLite transaction (insert_batch)
        — per-row commits pay one fsync per page. Capacity is enforced in
        room-sized sub-batches so duplicates don't consume cap slots
        (matches the per-row check's semantics)."""
        rows = list(zip(urls, titles, texts, embeddings))
        out: list[int | None] = []
        accepted_rows: list[np.ndarray] = []
        i = 0
        while i < len(rows):
            room = self.max_pages - len(self.store)
            if room <= 0:
                log.debug("index full (%d pages); skipping %d pages",
                          self.max_pages, len(rows) - i)
                out.extend([None] * (len(rows) - i))
                break
            chunk = rows[i: i + room]
            ids = self.store.insert_batch(
                [(u, t, x, np.asarray(e, np.float32))
                 for u, t, x, e in chunk])
            out.extend(ids)
            accepted_rows.extend(
                np.asarray(r[3], np.float32)
                for r, pid in zip(chunk, ids) if pid is not None)
            i += len(chunk)
        if accepted_rows:
            with self.ingest_gate, self.device_lock:
                self.index.add(np.stack(accepted_rows))
            METRICS.inc("pages_inserted", len(accepted_rows))
        return out

    def screen(self, urls: Sequence[str]) -> list[bool]:
        """Which of `urls` would insert (not duplicate, not over the page
        cap) — the pre-check the fused ingest path needs because it
        writes the index before the store."""
        out: list[bool] = []
        seen: set[str] = set()
        room = self.max_pages - len(self.store)
        for url in urls:
            ok = (room > 0 and url not in seen
                  and not self.store.has_url(url))
            if ok:
                seen.add(url)
                room -= 1
            out.append(ok)
        return out

    def store_pages(
        self,
        urls: Sequence[str],
        titles: Sequence[str],
        texts: Sequence[str],
        embeddings: np.ndarray,
        base: int | None = None,
    ) -> list[int | None]:
        """Store-only insert (the device index was already written by the
        fused ingest program). Rows must have passed screen().

        The index wrote these rows FIRST, so a mid-batch store failure
        would silently shift the row_id -> store_id(+1) mapping for
        every later row: on a rejected insert we roll the index back to
        the stored prefix and route the remainder through the
        store-first path; on an unexpected rowid (store and index
        irreconcilably diverged) we rebuild the index from the store.

        `base` is the device row of rows[0]. The default (current index
        length minus n) is only correct when no LATER batch has been
        dispatched yet; the pipelined ingest path (search_service
        insert_pages overlaps batch i's readback with batch i+1's
        dispatch) captures base at its own dispatch time and passes it
        explicitly. A rollback with later batches in flight orphans
        their device rows; their store_pages calls then see the rowid
        mismatch and take the rebuild-from-store path — heavy, correct,
        and only reachable through disk-level store failures (screen()
        under the ingest gate already excludes duplicates/cap).
        """
        rows = list(zip(urls, titles, texts, embeddings))
        n = len(rows)
        if base is None:
            base = len(self.index) - n  # device row of rows[0]
        ids: list[int | None] = []
        # ingest_gate: the recovery paths mutate the index (rollback /
        # rebuild-from-db), which must not interleave with a snapshot
        # readback; reentrant under the service's outer hold
        with METRICS.timer("ingest_store"), \
                self.ingest_gate, self.store.transaction():
            ids = self._store_pages_verified(rows, base, n)
        METRICS.inc("pages_inserted", sum(1 for i in ids if i is not None))
        return ids

    def _store_pages_verified(self, rows, base: int, n: int
                              ) -> list[int | None]:
        ids: list[int | None] = []
        for j, (url, title, text, emb) in enumerate(rows):
            sid = self.store.insert(url, title, text, emb)
            if sid == base + j + 1:
                ids.append(sid)
                continue
            if sid is None and hasattr(self.index, "count"):
                log.warning("store rejected %r mid-batch; rolling back "
                            "%d index rows", url, n - j)
                with self.device_lock:
                    self.index.count = base + j  # tail rows become scratch
                ids.append(None)
                rest = rows[j + 1:]
                if rest:
                    ids.extend(self.insert_pages(
                        [r[0] for r in rest], [r[1] for r in rest],
                        [r[2] for r in rest],
                        np.stack([np.asarray(r[3], np.float32)
                                  for r in rest])))
                break
            # sid is not None but at the wrong rowid (or the index can't
            # roll back): the store is the source of truth — finish
            # storing, then rebuild the device index wholesale.
            log.error("store id %s != expected %d for %r; rebuilding "
                      "index from store", sid, base + j + 1, url)
            ids.append(sid)
            for url2, title2, text2, emb2 in rows[j + 1:]:
                ids.append(self.store.insert(url2, title2, text2, emb2))
            with self.device_lock:
                self.index = self._make_index()
                self._fill_index_from_db()
            break
        return ids

    # -- search -----------------------------------------------------------

    def fetch_width(self, k: int) -> int:
        """Candidate count to request from the index for a final top-k.

        Quantized storage overfetches so the host f32 re-rank can
        restore exact ordering; i4 widens further by the count-keyed
        ladder (ops/quant.i4_fetch_width: k + 30 loses re-ranked recall
        on i4 codes). Indexes with a device-side exact re-rank
        (FlatIndex exact="f16") come back already re-ranked. ONE
        definition shared by the split path here and the fused text path
        (serving/search_service.py) so they cannot drift."""
        quantized = getattr(self.index, "dtype", "f32") != "f32"
        on_device = getattr(self.index, "device_rerank", False)
        if not (quantized and self.rerank and not on_device):
            return k
        k_fetch = k + self.rerank
        if getattr(self.index, "dtype", "") == "i4":
            k_fetch = max(k_fetch, i4_fetch_width(len(self.index), k))
        return k_fetch

    def search_embeddings(
        self, queries: np.ndarray, k: int = 20, instance_id: str = "",
        dispatch_lock=None,
    ) -> list[SearchResult]:
        """Batched query -> per-query top-k with metadata join
        (search_provider.rs:202-248, batched).

        `dispatch_lock`: hold this lock only while the search program
        is ENQUEUED (index.search_dispatch), releasing it for the
        execution wait, re-rank, and store join — the same tail-latency
        contract as the fused text path (serving/search_service.py).
        None = plain blocking search."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        # Reject non-unit queries like the reference
        # (search_provider.rs:206-208, tolerance vector.rs:185-192).
        # Also a kernel precondition: the fused selector's packed-key
        # integer compare needs dot < 2 (ops/scan_select.py).
        norms = np.linalg.norm(queries, axis=1)
        if queries.shape[0] and not np.all(np.abs(norms - 1.0) <= 0.01):
            bad = float(norms[np.argmax(np.abs(norms - 1.0))])
            raise ValueError(
                f"query embedding not normalized (length {bad:.4f}); "
                "normalize before searching")
        k_fetch = self.fetch_width(k)
        if dispatch_lock is not None and hasattr(self.index,
                                                 "search_dispatch"):
            with dispatch_lock:
                pending = self.index.search_dispatch(queries, k_fetch)
            dists, ids = self.index.search_finalize(
                pending[0], pending[1], k_fetch, *pending[2:])
        else:
            dists, ids = self.index.search(queries, k_fetch)
        if k_fetch > k:
            dists, ids = self._rerank_f32(queries, dists, ids, k)
        return self.results_from_ids(dists, ids, instance_id)

    def _rerank_f32(self, queries: np.ndarray, dists: np.ndarray,
                    ids: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact-distance re-rank of quantized candidates using the
        store's f32 embeddings; rows missing from the store keep their
        approximate distance. Fully vectorized — one batched gather +
        einsum instead of a per-candidate Python loop."""
        cand = sorted({int(i) + 1 for i in ids.flatten() if i >= 0})
        embs = self.store.embeddings_for(cand)
        present = np.asarray([c for c in cand if embs.get(c) is not None],
                             dtype=np.int64)
        valid = (ids >= 0) & np.isfinite(dists)
        if len(present):
            E = np.stack([embs[int(c)] for c in present]).astype(np.float32)
            want = ids.astype(np.int64) + 1
            pos = np.searchsorted(present, want)
            pos_c = np.minimum(pos, len(present) - 1)
            found = valid & (present[pos_c] == want)
            # exact dot only for the (B, k_fetch) candidate slots
            exact = 1.0 - np.einsum("bd,bkd->bk", queries.astype(np.float32),
                                    E[pos_c])
            d_new = np.where(found, exact, dists).astype(np.float32)
        else:
            d_new = dists.astype(np.float32)
        d_new = np.where(valid, d_new, np.inf)
        order = np.argsort(d_new, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(d_new, order, axis=1)
        out_i = np.take_along_axis(
            np.where(valid, ids, -1).astype(np.int64), order, axis=1)
        out_i = np.where(np.isfinite(out_d), out_i, -1)
        return out_d, out_i

    def results_from_ids(self, dists: np.ndarray, ids: np.ndarray,
                         instance_id: str = "") -> list[SearchResult]:
        """Join device search output (distances, row ids) with stored
        metadata (the SQLite join of search_provider.rs:218-240)."""
        results: list[SearchResult] = []
        # device row id -> sqlite rowid: insertion order is identical and
        # sqlite autoincrements from 1, so store_id = row_id + 1.
        flat_ids = sorted({int(i) + 1 for i in ids.flatten() if i >= 0})
        meta = self.store.get_many(flat_ids)
        for b in range(dists.shape[0]):
            pages = []
            for d, i in zip(dists[b], ids[b]):
                if i < 0 or not np.isfinite(d):
                    continue
                rec = meta.get(int(i) + 1)
                if rec is None:
                    continue
                pages.append(FoundPage(
                    page_id=rec.id, distance=float(d), url=rec.url,
                    title=rec.title, text=rec.text, instance_id=instance_id))
            results.append(SearchResult(pages=pages, pages_searched=len(self.index)))
        METRICS.inc("searches", dists.shape[0])
        return results

    def embedding_for_page(self, page_id: int) -> np.ndarray | None:
        return self.store.embedding_for_page(page_id)

    def stats(self) -> dict:
        return {"pages_indexed": len(self.store),
                "index_bytes": self.index.nbytes,
                "index_capacity": getattr(self.index, "capacity", None)}

    # -- persistence ------------------------------------------------------

    def save(self) -> None:
        """Snapshot the device index (search_provider.rs:173-181); SQLite
        is already durable. The device lock is held only to capture a
        consistent set of buffer references — the readback and disk
        write run OUTSIDE it, so the 10-minute autosave does not stall
        query dispatch for its duration. The readback is not safe
        against index writes (they land in place in the captured
        buffers), which is what ingest_gate excludes for the whole save;
        lock order is gate -> device, uniformly."""
        if self.index_path:
            t0 = time.perf_counter()
            # ingest_gate across the whole save: an ingest write would
            # change the captured buffers mid-readback. Searches never
            # write, so they keep dispatching — only ingest waits.
            with self.ingest_gate:
                with self.device_lock:
                    n = len(self.index)
                    write = (self.index.deferred_save()
                             if hasattr(self.index, "deferred_save")
                             else self.index.save)
                write(self.index_path)
            log.info("saved index (%d rows) in %.2fs",
                     n, time.perf_counter() - t0)

    def shutdown(self) -> None:
        self.save()
        self.store.close()
