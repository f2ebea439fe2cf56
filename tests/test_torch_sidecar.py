"""Sidecar embedding dumps: write from WARC, load, bulk-index.

The port's copy of tests/test_sidecar.py."""

import hashlib

import numpy as np
import torch

from dawnsearch_tpu_torch.index.provider import SearchProvider
from dawnsearch_tpu_torch.ingest.sidecar import (
    index_sidecars, load_sidecar, write_sidecar)
from dawnsearch_tpu_torch.ingest.warc import write_warc

torch.set_num_threads(2)

ENGLISH = ("The history of the lighthouse is a story of the sea and of the "
           "people who kept the light burning through every storm along "
           "this rocky coast for over a century of nights. ") * 5


def encode(texts):
    out = []
    for t in texts:
        seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "little")
        v = np.random.default_rng(seed).standard_normal(384)
        out.append((v / np.linalg.norm(v)).astype(np.float32))
    return np.stack(out)


def test_sidecar_roundtrip_and_bulk_index(tmp_path):
    warc = str(tmp_path / "in.warc.gz")
    write_warc(warc, [
        (f"https://sc.example/{i}",
         (f"<html><head><title>Doc {i}</title></head><body><p>{ENGLISH} "
          f"number {i}</p></body></html>").encode())
        for i in range(6)])
    out = str(tmp_path / "in.sidecar.npz")
    n = write_sidecar(warc, encode, out, batch_size=4)
    assert n == 6
    embs, urls, titles, texts = load_sidecar(out)
    assert embs.shape == (6, 384) and len(urls) == 6
    assert titles[0] == "Doc 0"
    np.testing.assert_allclose(np.linalg.norm(embs, axis=1), 1.0, atol=1e-5)

    provider = SearchProvider(data_dir=None, verify_on_load=False, device="cpu")
    total = index_sidecars(provider, [out])
    assert total == 6 and len(provider.store) == 6
    res = provider.search_embeddings(embs[3], k=1)[0]
    assert res.pages[0].url == "https://sc.example/3"


def test_open_warc_local_url_and_cc_key(tmp_path, monkeypatch):
    """open_warc resolves local paths, URLs, and crawl-data/ keys
    (the examples_old/index_url.rs capability)."""
    import functools
    import http.server
    import os
    import threading

    from dawnsearch_tpu_torch.ingest.sidecar import open_warc

    warc = str(tmp_path / "one.warc.gz")
    write_warc(warc, [
        ("https://u.example/0",
         f"<html><head><title>U</title></head><body><p>{ENGLISH}</p>"
         "</body></html>".encode())])

    # local path passes through untouched
    name, src = open_warc(warc)
    assert name == "one.warc.gz" and src == warc

    # URL form streams over HTTP and write_sidecar consumes the stream
    quiet = type("H", (http.server.SimpleHTTPRequestHandler,), {
        "log_message": lambda *a: None})
    handler = functools.partial(quiet, directory=str(tmp_path))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/one.warc.gz"
        name, src = open_warc(url)
        assert name == "one.warc.gz" and src is not warc
        out = str(tmp_path / "url.sidecar.npz")
        assert write_sidecar(src, encode, out) == 1
        _, urls, _, _ = load_sidecar(out)
        assert urls[0] == "https://u.example/0"

        # a bare crawl-data/... key resolves against the CC CDN host
        captured = {}

        def fake_urlopen(u, timeout=0):
            captured["url"] = u
            return open(warc, "rb")

        import urllib.request
        monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
        name, src = open_warc("crawl-data/CC-MAIN-2023-23/x/one.warc.gz")
        src.close()
        assert name == "one.warc.gz"
        assert captured["url"].startswith("https://data.commoncrawl.org/")
        # ...but an existing local file of the same shape wins
        monkeypatch.chdir(tmp_path)
        local = "crawl-data/here.warc.gz"
        os.makedirs("crawl-data", exist_ok=True)
        open(local, "wb").close()
        name, src = open_warc(local)
        assert src == local
    finally:
        httpd.shutdown()


def test_sidecar_max_pages(tmp_path):
    warc = str(tmp_path / "in.warc.gz")
    write_warc(warc, [
        (f"https://sc.example/{i}",
         (f"<html><body><p>{ENGLISH} {i}</p></body></html>").encode())
        for i in range(5)])
    out = str(tmp_path / "lim.npz")
    assert write_sidecar(warc, encode, out, batch_size=2, max_pages=3) == 3
