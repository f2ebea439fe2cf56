"""Sidecar embedding files: offline WARC -> packed embeddings on disk.

Rebuild of the reference's flat-file indexer
(the reference's src/index/warc.rs:35-125), which raw-byte-dumps
`PageEntry{url_pos, title_pos, vector[384], ...}` structs into per-WARC
`.emb/.url/.title` sidecars consumed by mmap
(examples_old/document_embeddings.rs). Here one `.npz` per WARC holds
aligned arrays (embeddings f32 (N,384), urls, titles, texts) — mmap-able
via np.load, bulk-loadable into any index, and the build loop reports
the same throughput meter (pages/s, ms/embedding, warc.rs:107-114).
Port of dawnsearch_tpu/ingest/sidecar.py with the same file layout, so a
sidecar written by either package loads in the other.
"""

from __future__ import annotations

import time

import numpy as np

from dawnsearch_tpu_torch.ingest.pages import iter_pages
from dawnsearch_tpu_torch.utils.logging import service_logger

log = service_logger("Sidecar")


def write_sidecar(warc_path: str, encode_fn, out_path: str,
                  batch_size: int = 256, max_pages: int | None = None
                  ) -> int:
    """Stream `warc_path`, embed pages in batches, write one .npz.
    Returns number of pages written. `encode_fn(texts) -> (N, D) f32`."""
    urls: list[str] = []
    titles: list[str] = []
    texts: list[str] = []
    embs: list[np.ndarray] = []
    batch: list = []
    t0 = time.perf_counter()

    def flush():
        nonlocal batch
        if not batch:
            return
        t1 = time.perf_counter()
        vecs = encode_fn([p.combined for p in batch])
        dt = time.perf_counter() - t1
        embs.append(np.asarray(vecs, np.float32))
        for p in batch:
            urls.append(p.url)
            titles.append(p.title)
            texts.append(p.text)
        log.info("embedded %d pages (%.1f ms/embedding, %.1f pages/s)",
                 len(batch), 1e3 * dt / len(batch), len(batch) / max(dt, 1e-9))
        batch = []

    for page in iter_pages(warc_path):
        batch.append(page)
        if len(batch) >= batch_size:
            flush()
        if max_pages is not None and \
                len(urls) + len(batch) >= max_pages:
            break
    flush()
    n = len(urls)
    np.savez_compressed(
        out_path if out_path.endswith(".npz") else out_path + ".npz",
        embeddings=(np.concatenate(embs) if embs
                    else np.zeros((0, 384), np.float32)),
        urls=np.array(urls), titles=np.array(titles), texts=np.array(texts))
    log.info("sidecar %s: %d pages in %.1fs", out_path, n,
             time.perf_counter() - t0)
    return n


def open_warc(spec: str):
    """Local path, URL, or Common Crawl key -> (name, path-or-stream)
    consumable by iter_pages / write_sidecar.

    The URL form is the examples_old/index_url.rs capability (fetch ONE
    named WARC from the crawl bucket and sidecar it); a bare
    `crawl-data/...` key resolves against the Common Crawl CDN the same
    way index_url.rs prefixes data.commoncrawl.org."""
    import io
    import os
    import urllib.request

    url = None
    if spec.startswith(("http://", "https://")):
        url = spec
    elif not os.path.exists(spec) and spec.startswith("crawl-data/"):
        url = f"https://data.commoncrawl.org/{spec}"
    if url is not None:
        name = url.rsplit("/", 1)[-1]
        return name, io.BufferedReader(
            urllib.request.urlopen(url, timeout=120))
    return os.path.basename(spec), spec


def load_sidecar(path: str):
    """-> (embeddings (N, D) f32, urls, titles, texts) numpy arrays."""
    z = np.load(path if path.endswith(".npz") else path + ".npz",
                allow_pickle=False)
    return z["embeddings"], z["urls"], z["titles"], z["texts"]


def index_sidecars(provider, paths: list[str], batch: int = 4096) -> int:
    """Bulk-load sidecar files into a SearchProvider (store + index)."""
    total = 0
    for p in paths:
        embs, urls, titles, texts = load_sidecar(p)
        for s in range(0, len(urls), batch):
            e = embs[s: s + batch]
            provider.insert_pages(
                list(urls[s: s + batch]), list(titles[s: s + batch]),
                list(texts[s: s + batch]), e)
            total += len(e)
    return total
