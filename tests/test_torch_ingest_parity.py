"""The port's ingest held against the reference's.

- Pages: the same seeded WARC files (gzip and plain; HTML response
  records, WET conversion records, and records every filter drops) go
  through both packages' iter_pages, each with its native readers (the
  C++ WARC parser, extractor and English filter) and with its Python
  ones: all four give the same (url, title, text) triples in the same
  order.
- Sidecars: a sidecar written by either package loads in the other
  (load_sidecar, index_sidecars).
- Nodes: a port node and a reference node, each with index_cc over the
  same WARC file (warc_source), a small ingest_batch_size and the same
  2-layer checkpoint at compute_dtype = "f32", store the same pages in
  the same order with embeddings within atol 1e-4 (the reference's f32
  tolerance, tests/test_bert.py), and each finds every page from its own
  text at rank 1.
- Workers: the spawned extraction worker's code path loads no torch, so
  a worker never creates a CUDA context on the node's card.
"""

import gzip
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dawnsearch_tpu.config import Config as RefConfig
from dawnsearch_tpu.index.provider import SearchProvider as RefProvider
from dawnsearch_tpu.ingest import pages as ref_pages
from dawnsearch_tpu.ingest import sidecar as ref_sidecar
from dawnsearch_tpu.ingest import warc as ref_warc
from dawnsearch_tpu.node import DawnNode as RefNode
from dawnsearch_tpu.utils import nativelib as ref_nativelib
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.index.provider import SearchProvider
from dawnsearch_tpu_torch.ingest import native, pages, sidecar, warc
from dawnsearch_tpu_torch.models.bert import BertConfig
from dawnsearch_tpu_torch.models.tokenizer import build_vocab_from_corpus
from dawnsearch_tpu_torch.models.weights import (params_from_numpy,
                                                 save_safetensors)
from dawnsearch_tpu_torch.node import DawnNode
from dawnsearch_tpu_torch.utils import nativelib

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_rng = np.random.default_rng(13)
WORDS = ["lighthouse", "harbour", "keeper", "storm", "ship", "rock", "light",
         "coast", "night", "sea", "village", "bell", "fog", "wave", "island",
         "rope", "lamp", "tower", "boat", "sailor"]
STOP = ["the", "of", "and", "a", "to", "in", "is", "was", "it", "for"]
GERMAN = ("Die Geschichte des Leuchtturms ist eine Geschichte des Meeres "
          "und der Menschen, die das Licht durch jeden Sturm am Brennen "
          "hielten. ") * 8


def english(rng: np.random.Generator, n_words: int) -> str:
    """English-looking prose: content words with enough stopwords to
    pass the language gate."""
    return " ".join(rng.choice(WORDS) if rng.random() < 0.6
                    else rng.choice(STOP) for _ in range(n_words)) + "."


def html(title: str, body: str) -> bytes:
    return (f"<html><head><title>{title}</title></head><body>"
            f"<nav><a href='/a'>Home</a> <a href='/b'>About</a></nav>"
            f"<article><p>{body}</p></article>"
            f"<footer>contact us</footer></body></html>").encode()


def raw_record(url: str, warc_type: str, payload_type: str | None,
               body: bytes) -> bytes:
    """One WARC record, its payload type header optional (write_warc
    always writes one)."""
    head = [b"WARC/1.0", b"WARC-Type: " + warc_type.encode(),
            b"WARC-Target-URI: " + url.encode()]
    if payload_type is not None:
        head.append(b"WARC-Identified-Payload-Type: " + payload_type.encode())
    head.append(b"Content-Length: " + str(len(body)).encode())
    return b"\r\n".join(head) + b"\r\n\r\n" + body + b"\r\n\r\n"


def corpus(rng: np.random.Generator, n: int) -> bytes:
    """n records of every kind iter_pages meets, in a seeded order:
    accepted HTML pages (some titled, some with the text past 2048
    chars), WET conversion records, and records dropped by each filter
    (short text, German, `?` in the URL, an image, no payload type, a
    request record, a body under 500 bytes)."""
    envelope = b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n\r\n"
    out = []
    for i in range(n):
        kind = rng.choice(["page", "page", "page", "long", "wet", "short",
                           "german", "query", "image", "untyped", "request",
                           "tiny"])
        text = english(rng, int(rng.integers(90, 300)))
        url = f"https://site{i % 7}.example/{kind}/{i}"
        if kind in ("page", "long", "query", "short", "german", "untyped",
                    "request", "tiny"):
            body = {"long": html(f"Long {i}", text * 4),
                    "short": html(f"Short {i}", "too short " * 20),
                    "german": html(f"Deutsch {i}", GERMAN),
                    "tiny": b"<p>tiny</p>"}.get(kind, html(
                        f"Page {i}" if i % 3 else "", text))
            out.append(raw_record(
                url + ("?id=1" if kind == "query" else ""),
                "request" if kind == "request" else "response",
                None if kind == "untyped" else "text/html", envelope + body))
        elif kind == "wet":
            out.append(raw_record(url, "conversion", "text/plain",
                                  text.encode()))
        else:
            out.append(raw_record(url, "response", "image/png",
                                  envelope + bytes(rng.integers(0, 256, 900,
                                                                np.uint8))))
    return b"".join(out)


@pytest.fixture(scope="module")
def warc_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("warcs")
    rng = np.random.default_rng(5)
    paths = []
    for name, n in (("a.warc.gz", 120), ("b.warc", 80)):
        blob = corpus(rng, n)
        p = str(d / name)
        with (gzip.open if name.endswith(".gz") else open)(p, "wb") as f:
            f.write(blob)
        paths.append(p)
    return paths


def _triples(mod_pages, path) -> list:
    return [(p.url, p.title, p.text) for p in mod_pages.iter_pages(path)]


def test_page_triples_match_the_reference(warc_files, monkeypatch):
    """Both packages, native and Python readers: the same triples."""
    assert nativelib.get() is not None and nativelib.get_warc() is not None
    assert ref_nativelib.get() is not None
    for path in warc_files:
        got = {"port-native": _triples(pages, path),
               "ref-native": _triples(ref_pages, path)}
        with monkeypatch.context() as m:
            m.setattr(nativelib, "get", lambda: None)
            m.setattr(nativelib, "get_warc", lambda: None)
            m.setattr(ref_nativelib, "get", lambda: None)
            assert native.readers()["warc"] == "python"
            assert native.readers()["extract"] == "python"
            got["port-python"] = _triples(pages, path)
            got["ref-python"] = _triples(ref_pages, path)
        want = got["ref-python"]
        # every kind of record was met: kept pages, WET text, drops
        assert 20 < len(want) < 100
        assert any(t[0].split("/")[3] == "wet" for t in want)
        assert any(t[1] == "" for t in want) and any(t[1] for t in want)
        assert not any(t[0].split("/")[3] in ("short", "german", "query",
                                              "image", "untyped", "request",
                                              "tiny") for t in want)
        for label, triples in got.items():
            assert triples == want, (path, label)


def test_write_warc_writes_the_references_bytes(tmp_path):
    records = [(f"https://w.example/{i}", html(f"T{i}", english(_rng, 80)))
               for i in range(5)]
    for kw in ({}, {"warc_type": "conversion", "payload_type": "text/plain"}):
        warc.write_warc(str(tmp_path / "port.warc"), records, **kw)
        ref_warc.write_warc(str(tmp_path / "ref.warc"), records, **kw)
        assert (tmp_path / "port.warc").read_bytes() == \
            (tmp_path / "ref.warc").read_bytes()


class HashEncoder:
    dim = 384

    def encode(self, texts):
        out = []
        for t in texts:
            seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4],
                                  "little")
            v = np.random.default_rng(seed).standard_normal(384)
            out.append((v / np.linalg.norm(v)).astype(np.float32))
        return np.stack(out)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sidecars_cross_load(warc_files, tmp_path, writer):
    """A sidecar written by one package loads in the other: the same
    arrays, and index_sidecars fills the other's provider with them."""
    write, load = ((sidecar.write_sidecar, ref_sidecar)
                   if writer == "port" else
                   (ref_sidecar.write_sidecar, sidecar))
    out = str(tmp_path / "a.sidecar.npz")
    n = write(warc_files[0], HashEncoder().encode, out, batch_size=16)
    assert n == len(_triples(pages, warc_files[0]))
    mine = (sidecar if writer == "port" else ref_sidecar).load_sidecar(out)
    theirs = load.load_sidecar(out)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    if writer == "port":
        provider = RefProvider(data_dir=None, verify_on_load=False)
    else:
        provider = SearchProvider(data_dir=None, verify_on_load=False,
                                  device="cpu")
    try:
        assert load.index_sidecars(provider, [out]) == n
        assert len(provider.store) == n
        rec, emb = provider.store.get(3)
        assert rec.url == str(theirs[1][2])
        np.testing.assert_array_equal(emb, theirs[0][2])
    finally:
        provider.shutdown()


VOCAB, H, NH, I, L, P = 512, 128, 4, 256, 2, 64


def _checkpoint(model_dir, texts) -> None:
    """A 2-layer BERT checkpoint (config.json, model.safetensors from a
    seeded numpy tree through params_from_numpy, vocab.txt of the
    corpus's words) that both packages' make_encoder load."""
    rng = np.random.default_rng(21)

    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1
                ).astype(np.float32)
    tree = {"embeddings": {"word": w(VOCAB, H), "position": w(P, H),
                           "token_type": w(2, H), "ln_scale": v(H, base=1.0),
                           "ln_bias": v(H)},
            "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                       "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                       "attn_ln_scale": v(L, H, base=1.0),
                       "attn_ln_bias": v(L, H), "ffn_in_w": w(L, H, I),
                       "ffn_in_b": v(L, I), "ffn_out_w": w(L, I, H),
                       "ffn_out_b": v(L, H),
                       "ffn_ln_scale": v(L, H, base=1.0),
                       "ffn_ln_bias": v(L, H)}}
    os.makedirs(model_dir)
    shape = BertConfig(vocab_size=VOCAB, hidden_size=H, num_layers=L,
                       num_heads=NH, intermediate_size=I,
                       max_position_embeddings=P)
    save_safetensors(params_from_numpy(tree),
                     os.path.join(model_dir, "model.safetensors"), shape)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "hidden_act": "gelu",
                   "hidden_size": H, "num_hidden_layers": L,
                   "num_attention_heads": NH, "intermediate_size": I,
                   "vocab_size": VOCAB, "max_position_embeddings": P,
                   "pad_token_id": 0}, f)
    vocab = build_vocab_from_corpus(texts, size=VOCAB)
    with open(os.path.join(model_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")


def _wait(pred, timeout: float = 240.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def test_nodes_ingest_the_same_store(tmp_path):
    """index_cc + warc_source on both packages' nodes: the same pages, in
    the same order, embeddings within atol 1e-4, each page at rank 1."""
    rng = np.random.default_rng(8)
    records, texts = [], []
    for i in range(14):
        # a distinct opening sentence: the encoder reads 64 tokens
        text = f"{WORDS[i]} {WORDS[(3 * i + 1) % 20]} {i} " + english(rng, 120)
        texts.append(text)
        records.append((f"https://ingest.example/{i}", html(f"Page {i}", text)))
    records.append(("https://ingest.example/de", html("De", GERMAN)))
    path = str(tmp_path / "crawl.warc.gz")
    warc.write_warc(path, records)
    model_dir = str(tmp_path / "model")
    _checkpoint(model_dir, texts)
    common = dict(index_cc=True, warc_source=path, ingest_batch_size=4,
                  compute_dtype="f32", model_dir=model_dir,
                  seq_buckets=(32, 64))
    port = DawnNode(Config(device="cpu", data_dir=str(tmp_path / "port"),
                           **common))
    ref = RefNode(RefConfig(data_dir=str(tmp_path / "ref"), **common))
    for node in (port, ref):
        node.start()
    try:
        for node in (port, ref):
            assert _wait(lambda: len(node.provider.store) == 14), \
                len(node.provider.store)
            assert _wait(lambda: node.extractor.ledger.seen(path))
        for pid in range(1, 15):
            (got, e_got), (want, e_want) = (port.provider.store.get(pid),
                                            ref.provider.store.get(pid))
            assert (got.url, got.title, got.text) == \
                (want.url, want.title, want.text)
            np.testing.assert_allclose(e_got, e_want, atol=1e-4)
            q = f"{got.title}\n{got.text}"
            for node in (port, ref):
                res = node.service.text_search(q, search_remote=False)
                assert res.pages[0].page_id == pid
    finally:
        for node in (port, ref):
            node.stop()


def test_extraction_worker_loads_no_torch(warc_files):
    """The extraction worker's whole code path in a fresh interpreter, as
    the spawn context starts it: it ships every page and never imports
    torch (so it cannot create a CUDA context)."""
    code = (
        "import queue, sys\n"
        "from dawnsearch_tpu_torch.ingest.extraction_service import "
        "_extract_worker\n"
        "specs, out = queue.Queue(), queue.Queue()\n"
        f"specs.put(('a', {warc_files[0]!r}))\n"
        "specs.put(None)\n"
        "_extract_worker(specs, out, 16)\n"
        "n = 0\n"
        "while True:\n"
        "    kind, name, payload = out.get()[:3]\n"
        "    if kind == 'batch':\n"
        "        n += len(payload)\n"
        "    if kind == 'exit':\n"
        "        break\n"
        "print(n, 'torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, loaded = out.stdout.split()
    assert int(n) == len(_triples(pages, warc_files[0]))
    assert loaded == "False"
