"""The served slice end to end: the port's SearchService vs the reference's,
and the port's node.

Both services run on in-memory providers with the same bridged weights,
the same vocab and the same 64 inserted pages; text queries must return
the same page ids in the same order, below and above the fused-selector
gate. The fused ingest into an i4 index writes the reference's bytes, and
the fused query over i4 and bf16 indexes returns the reference's ids. A
dispatch that fails mid-insert leaves as many rows stored as indexed. The
model is narrow (H=128, 4 heads of 32, I=256, 2 layers) but
inside the reference's whole-layer kernel envelope (H % 128 == 0,
128 % head_dim == 0), so the reference serves through its K1 kernel in
interpret mode, not its per-op fallback.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.index.provider import SearchProvider as RefProvider
from dawnsearch_tpu.models.bert import BertConfig as RefConfig
from dawnsearch_tpu.models.encoder import SentenceEncoder as RefEncoder
from dawnsearch_tpu.models.tokenizer import WordPieceTokenizer as RefTokenizer
from dawnsearch_tpu.serving.batcher import EmbeddingBatcher as RefBatcher
from dawnsearch_tpu.serving.search_service import SearchService as RefService
from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.index.flat import FlatIndex
from dawnsearch_tpu_torch.index.provider import SearchProvider
from dawnsearch_tpu_torch.models.bert import BertConfig
from dawnsearch_tpu_torch.models.encoder import SentenceEncoder
from dawnsearch_tpu_torch.models.tokenizer import (WordPieceTokenizer,
                                                   build_vocab_from_corpus)
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.node import DawnNode, check_config, make_index_factory
from dawnsearch_tpu_torch.ops import quant
from dawnsearch_tpu_torch.serving.batcher import EmbeddingBatcher
from dawnsearch_tpu_torch.serving.fused import FusedIngestPath, FusedQueryPath
from dawnsearch_tpu_torch.serving.search_service import SearchService

torch.set_num_threads(2)

VOCAB, H, NH, I, L, P = 2048, 128, 4, 256, 2, 64
SHAPE = dict(vocab_size=VOCAB, hidden_size=H, num_layers=L, num_heads=NH,
             intermediate_size=I, max_position_embeddings=P)
BUCKETS = dict(seq_buckets=(16, 32), batch_buckets=(1, 8, 32, 64))

_rng = np.random.default_rng(0)
WORDS = sorted({"".join(_rng.choice(list("abcdefghijklmnopqrstuvwxyz"), n))
                for n in _rng.integers(3, 9, 300)})
PAGES = [" ".join(_rng.choice(WORDS, 12)) for _ in range(64)]
QUERIES = PAGES[::9] + [" ".join(_rng.choice(WORDS, 6)) for _ in range(4)]


def params_tree(rng: np.random.Generator) -> dict:
    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1).astype(np.float32)

    return {
        "embeddings": {"word": w(VOCAB, H), "position": w(P, H),
                       "token_type": w(2, H), "ln_scale": v(H, base=1.0),
                       "ln_bias": v(H)},
        "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                   "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                   "attn_ln_scale": v(L, H, base=1.0), "attn_ln_bias": v(L, H),
                   "ffn_in_w": w(L, H, I), "ffn_in_b": v(L, I),
                   "ffn_out_w": w(L, I, H), "ffn_out_b": v(L, H),
                   "ffn_ln_scale": v(L, H, base=1.0), "ffn_ln_bias": v(L, H)},
    }


@pytest.fixture(scope="module")
def tree():
    return params_tree(np.random.default_rng(1))


@pytest.fixture(scope="module")
def vocab():
    return build_vocab_from_corpus(PAGES + QUERIES, size=VOCAB)


def port_encoder(tree, vocab):
    return SentenceEncoder(params_from_numpy(tree), WordPieceTokenizer(vocab),
                           cfg=BertConfig(**SHAPE), device="cpu", **BUCKETS)


@pytest.fixture(scope="module")
def ref_encoder(tree, vocab):
    params = {k: {n: jnp.asarray(a) for n, a in d.items()}
              for k, d in tree.items()}
    return RefEncoder(params, RefTokenizer(vocab),
                      cfg=RefConfig(**SHAPE, layer_impl="layer"), **BUCKETS)


def _factory(make, exact):
    def factory():
        return make(exact=exact)
    return factory


@pytest.mark.parametrize("rerank", ["host", "device"])
@pytest.mark.parametrize("fused_gate", ["default", "lowered"])
def test_text_search_matches_reference(tree, vocab, ref_encoder, fused_gate,
                                       rerank):
    """rerank="device" keeps the f16 shadow: the fused ingest writes it and
    the fused query re-ranks from it, with no host re-rank."""
    from dawnsearch_tpu.index.flat import FlatIndex as RefIndex

    exact = "f16" if rerank == "device" else None
    ref_b = RefBatcher(ref_encoder.encode, max_batch=8)
    ref = RefService(RefProvider(
        data_dir=None, dim=H, verify_on_load=False,
        index_factory=_factory(lambda **kw: RefIndex(dim=H, **kw), exact)),
        ref_b, instance_id="ref")
    enc = port_encoder(tree, vocab)
    port_b = EmbeddingBatcher(enc.encode, max_batch=8)
    port = SearchService(SearchProvider(
        data_dir=None, dim=H, verify_on_load=False, device="cpu",
        index_factory=_factory(
            lambda **kw: FlatIndex(dim=H, device="cpu", **kw), exact)),
        port_b, encoder=enc, instance_id="port")
    try:
        assert isinstance(port.provider.index, FlatIndex)
        assert port._fused is not None and port._fused_ingest is not None
        assert port.provider.index.device_rerank == (rerank == "device")
        if fused_gate == "lowered":
            ref.provider.index.fused_min_rows = 0
            port.provider.index.fused_min_rows = 0
        pages = [(f"https://p/{i}", f"T{i}", t) for i, t in enumerate(PAGES)]
        assert port.insert_pages(pages) == ref.insert_pages(pages)
        for q in QUERIES:
            want = ref.text_search(q, search_remote=False)
            got = port.text_search(q, search_remote=False)
            assert [p.page_id for p in got.pages] == \
                [p.page_id for p in want.pages], q
            np.testing.assert_allclose([p.distance for p in got.pages],
                                       [p.distance for p in want.pages],
                                       atol=1e-5)
            assert got.pages_searched == want.pages_searched == len(PAGES)
        # a page's own text ranks it first
        assert port.text_search(PAGES[5]).pages[0].url == "https://p/5"
    finally:
        for svc, b in ((ref, ref_b), (port, port_b)):
            b.stop()
            svc.shutdown()


SETTINGS = [("model_dir", "/models/minilm"), ("udp", True), ("index_cc", True),
            ("index_kind", "sharded"), ("dist_num_processes", 2),
            ("layer_impl", "layer_i8"), ("layer_impl", "ops"),
            ("attn_impl", "xla"), ("pool_impl", "fused"),
            ("compute_dtype", "f32")]


@pytest.mark.parametrize("field,value", SETTINGS)
def test_node_refuses_unported_settings(tmp_path, field, value):
    """Every setting of the reference's config is served now, so each of
    these passes check_config; a value outside a setting's table is
    refused before the data dir is touched, and a crew without a sharded
    index is refused by the index factory, as in the reference."""
    cfg = Config(device="cpu", data_dir=str(tmp_path), **{field: value})
    check_config(cfg)
    if field == "dist_num_processes":
        with pytest.raises(ValueError, match="sharded"):
            make_index_factory(cfg)
        cfg.index_kind = "sharded"
        make_index_factory(cfg)
    elif field == "index_kind":
        assert make_index_factory(cfg).load_kwargs()["mesh"].shape == \
            {"shard": 1}
    tabled = field in ("index_kind", "layer_impl", "attn_impl", "pool_impl",
                       "compute_dtype")
    bad = Config(device="cpu", data_dir=str(tmp_path),
                 **{field if tabled else "index_kind": "bogus"})
    with pytest.raises(ValueError, match="unknown"):
        DawnNode(bad)
    assert not os.listdir(tmp_path)  # refused before touching the data dir


def _wait(pred, timeout: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("service", ["udp", "index_cc"])
def test_node_starts_udp_and_ingest_on_the_cpu(tree, vocab, tmp_path, service):
    """The two services the node refused before the port covered them:
    with udp it announces itself to a tracker and serves; with index_cc it
    ingests a WARC file from warc_source through the extractor and records
    it in its ledger; either way a page's own text finds it at rank 1 over
    HTTP, and stop() ends the service."""
    from dawnsearch_tpu_torch.ingest.warc import write_warc
    from dawnsearch_tpu_torch.net.tracker import Tracker

    tracker = Tracker("127.0.0.1:0").start()
    english = ("the lighthouse was built on the rocks by the people of the "
               "town, and it has stood there for more than a century while "
               "the sea broke on the stones below it. ")
    texts = [f"{PAGES[i]} {english * 4}" for i in range(12)]
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path / "data"))
    if service == "udp":
        cfg.udp, cfg.udp_listen_address = True, "127.0.0.1:0"
        cfg.trackers = [f"127.0.0.1:{tracker.port}"]
        cfg.announce_interval_s = 0.1
    else:
        warc = str(tmp_path / "crawl-0.warc.gz")
        write_warc(warc, [(f"https://w/{i}", f"<html><head><title>T{i}</title>"
                           f"</head><body><p>{t}</p></body></html>".encode())
                          for i, t in enumerate(texts)])
        cfg.index_cc, cfg.warc_source, cfg.ingest_batch_size = True, warc, 4
    node = DawnNode(cfg, encoder=port_encoder(tree, vocab)).start()
    try:
        base = f"http://127.0.0.1:{node.http_port}"
        if service == "udp":
            assert node.udp is not None and node.extractor is None
            assert _wait(lambda: node.instance_id in tracker.peers)
            pages = [{"url": f"https://w/{i}", "title": f"T{i}", "text": t}
                     for i, t in enumerate(texts)]
            assert len(_http(base + "/api/insert",
                             {"pages": pages})["inserted"]) == 12
        else:
            assert node.udp is None and node.extractor is not None
            assert _wait(lambda: len(node.provider.store) == 12)
            assert _wait(lambda: node.extractor.ledger.seen(warc))
        q = "T5\n" + node.provider.store.get(6)[0].text
        got = _http(base + "/api/search?q=" + urllib.parse.quote(q))
        assert got["results"][0]["url"] == "https://w/5"
    finally:
        node.stop()
        tracker.stop()
    if service == "udp":
        assert node.udp._stop.is_set()
    else:
        assert not node.extractor._insert_thread.is_alive()


@pytest.mark.parametrize("field", ["attn_impl", "layer_impl", "pool_impl",
                                   "wire_format", "wire_embedding"])
def test_node_refuses_an_unknown_route(tmp_path, field):
    """A typo must not quietly pick a route (attn_impl="fusd" would run
    the whole-layer kernel, as the reference's bert.py:180 reads it;
    wire_format="fusd" would speak the dawn wire, as the reference's
    net/udp_service.py reads it)."""
    cfg = Config(device="cpu", data_dir=str(tmp_path), **{field: "fusd"})
    with pytest.raises(ValueError, match=f"unknown {field} 'fusd'"):
        DawnNode(cfg)
    assert not os.listdir(tmp_path)


def test_node_serves_the_per_op_path(tmp_path):
    """layer_impl="ops" and pool_impl="fused" reach the node's own
    encoder (make_encoder, MiniLM width), which serves an inserted page
    at rank 1; on the CPU every kernel wrapper runs its plain twin."""
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path), layer_impl="ops",
                 pool_impl="fused")
    node = DawnNode(cfg).start()
    try:
        mcfg = node.encoder.model.cfg
        assert (mcfg.layer_impl, mcfg.attn_impl, mcfg.pool_impl) == \
            ("ops", "fused", "fused")
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://o/{i}", "title": "", "text": t}
                 for i, t in enumerate(PAGES[:8])]
        assert len(_http(base + "/api/insert", {"pages": pages})["inserted"]) == 8
        got = _http(base + "/api/search?q=" + urllib.parse.quote(PAGES[6]))
        assert got["results"][0]["url"] == "https://o/6"
        metrics = _http(base + "/api/metrics")
        assert not any(metrics.get(n, 0) for n in (
            "kernel_attention_packed", "kernel_ffn", "kernel_mean_pool",
            "kernel_bert_layer"))
    finally:
        node.stop()


def test_node_serves_a_checkpoint_on_k4(tree, vocab, tmp_path):
    """A node on a model_dir (config.json, model.safetensors written by the
    port, vocab.txt) with layer_impl="layer_i8": make_encoder takes the
    checkpoint's shape, K4's route holds i8 weights, the index is as wide
    as the encoder, and an inserted page comes back at rank 1."""
    from dawnsearch_tpu_torch.models.weights import save_safetensors

    model_dir = tmp_path / "model"
    model_dir.mkdir()
    save_safetensors(params_from_numpy(tree), str(model_dir / "model.safetensors"),
                     BertConfig(**SHAPE))
    with open(model_dir / "config.json", "w") as f:
        json.dump({"model_type": "bert", "hidden_act": "gelu", "hidden_size": H,
                   "num_hidden_layers": L, "num_attention_heads": NH,
                   "intermediate_size": I, "vocab_size": VOCAB,
                   "max_position_embeddings": P, "pad_token_id": 0}, f)
    (model_dir / "vocab.txt").write_text(
        "\n".join(sorted(vocab, key=vocab.get)) + "\n", encoding="utf-8")
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path / "data"),
                 model_dir=str(model_dir), layer_impl="layer_i8",
                 seq_buckets=(16, 32))
    node = DawnNode(cfg).start()
    try:
        mcfg = node.encoder.model.cfg
        assert (mcfg.hidden_size, mcfg.num_layers, mcfg.layer_impl) == \
            (H, L, "layer_i8")
        assert node.encoder.model.layers[0].qkv_w_codes.dtype == torch.int8
        assert node.provider.index.dim == H
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://k/{i}", "title": "", "text": t}
                 for i, t in enumerate(PAGES[:8])]
        assert len(_http(base + "/api/insert", {"pages": pages})["inserted"]) == 8
        got = _http(base + "/api/search?q=" + urllib.parse.quote(PAGES[4]))
        assert got["results"][0]["url"] == "https://k/4"
        metrics = _http(base + "/api/metrics")
        assert metrics.get("kernel_bert_layer_i8", 0) == 0  # CPU: plain only
    finally:
        node.stop()


@pytest.mark.parametrize("dtype", ["i4", "bf16"])
def test_node_serves_each_index_tier(tree, vocab, tmp_path, dtype):
    """The two tiers the node refused before this port covered them: it
    starts with each, inserts pages and finds one at rank 1."""
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path), index_dtype=dtype)
    node = DawnNode(cfg, encoder=port_encoder(tree, vocab)).start()
    try:
        assert node.provider.index.dtype == dtype
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://t/{i}", "title": "", "text": t}
                 for i, t in enumerate(PAGES[:12])]
        assert len(_http(base + "/api/insert", {"pages": pages})["inserted"]) == 12
        got = _http(base + "/api/search?q=" + urllib.parse.quote(PAGES[7]))
        assert got["results"][0]["url"] == "https://t/7"
        assert len(node.provider.index) == 12
    finally:
        node.stop()


def test_insert_pages_stores_what_was_dispatched_when_a_dispatch_fails(
        tree, vocab, monkeypatch):
    """A top batch bucket of 8 cuts 20 pages into three dispatches, and
    the second raises. The first sub-batch's device rows have landed, so
    it is still stored: the store holds as many rows as the index, the
    error reaches the caller, and the next insert takes the rest."""
    enc = SentenceEncoder(params_from_numpy(tree), WordPieceTokenizer(vocab),
                          cfg=BertConfig(**SHAPE), device="cpu",
                          seq_buckets=(16, 32), batch_buckets=(1, 8))
    svc = SearchService(SearchProvider(
        data_dir=None, dim=H, verify_on_load=False, device="cpu",
        index_factory=lambda: FlatIndex(dim=H, device="cpu")),
        EmbeddingBatcher(enc.encode, max_batch=8), encoder=enc,
        instance_id="port")
    try:
        fi = svc._fused_ingest
        dispatch, calls = fi.dispatch, []

        def flaky(ids_list):
            calls.append(len(ids_list))
            if len(calls) == 2:
                raise RuntimeError("device fault")
            return dispatch(ids_list)
        monkeypatch.setattr(fi, "dispatch", flaky)
        pages = [(f"https://u/{i}", f"T{i}", t)
                 for i, t in enumerate(PAGES[:20])]
        with pytest.raises(RuntimeError, match="device fault"):
            svc.insert_pages(pages)
        prov = svc.provider
        assert calls == [8, 8]
        assert len(prov.store) == len(prov.index) == 8
        assert [prov.store.get(i)[0].url for i in (1, 8)] == \
            ["https://u/0", "https://u/7"]
        assert svc.insert_pages(pages) == [None] * 8 + list(range(9, 21))
        assert len(prov.store) == len(prov.index) == 20
        got = svc.text_search(PAGES[13], search_remote=False)
        assert got.pages[0].url == "https://u/13"
    finally:
        svc.shutdown()


def test_fused_ingest_i4_writes_the_references_bytes(tree, vocab, ref_encoder):
    """Two fused ingests into i4 indexes, the second at an unaligned count
    (a read-modify-write of the first's block). The port's rows hold the
    bytes the reference's i4 add writes for the same embeddings, and agree
    with the reference's own fused ingest from the same weights."""
    from dawnsearch_tpu.index.flat import FlatIndex as RefIndex
    from dawnsearch_tpu.serving.fused import FusedIngestPath as RefIngest

    port_ix = FlatIndex(dim=H, dtype="i4", device="cpu")
    ref_ix = RefIndex(dim=H, dtype="i4")
    port = FusedIngestPath(port_encoder(tree, vocab), port_ix)
    ref = RefIngest(ref_encoder, ref_ix)
    emb = np.concatenate([port.ingest(PAGES[:20]), port.ingest(PAGES[20:44])])
    for part in (PAGES[:20], PAGES[20:44]):
        ref.ingest(part)
    assert port_ix.count == ref_ix.count == 44
    # the reference's i4 add of the port's embeddings: the same bytes
    want = RefIndex(dim=H, dtype="i4")
    want.add(emb)
    block = port_ix._i4_block
    got_codes = quant.unpack_i4_np(port_ix._codes.numpy(), block)[:44]
    np.testing.assert_array_equal(
        got_codes, quant.unpack_i4_np(np.asarray(want._codes), block)[:44])
    np.testing.assert_array_equal(port_ix._scales.numpy()[:44],
                                  np.asarray(want._scales)[:44])
    # the reference's fused ingest encodes on its own kernels: nibbles at
    # a rounding edge may differ by one step
    ref_codes = quant.unpack_i4_np(np.asarray(ref_ix._codes), block)[:44]
    assert np.abs(got_codes.astype(int) - ref_codes).max() <= 1
    assert (got_codes == ref_codes).mean() > 0.99
    np.testing.assert_allclose(port_ix._scales.numpy()[:44],
                               np.asarray(ref_ix._scales)[:44], rtol=1e-2)


@pytest.mark.parametrize("dtype", ["i4", "bf16"])
def test_fused_query_over_each_tier_matches_reference(tree, vocab, ref_encoder,
                                                      dtype):
    """FusedQueryPath through the fused selector (K3 for i4, K2 bf16 for
    bf16; the gate lowered) over indexes holding the same embeddings."""
    from dawnsearch_tpu.index.flat import FlatIndex as RefIndex
    from dawnsearch_tpu.serving.fused import FusedQueryPath as RefQuery

    enc = port_encoder(tree, vocab)
    emb = enc.encode(PAGES)
    port_ix = FlatIndex(dim=H, dtype=dtype, device="cpu")
    ref_ix = RefIndex(dim=H, dtype=dtype)
    for ix in (port_ix, ref_ix):
        ix.fused_min_rows = 0
        ix.add(emb)
    assert port_ix.fused_eligible()
    (_, got_d, got_i), (_, want_d, want_i) = (
        path.finalize(*path.dispatch(QUERIES, 10)[:3], len(QUERIES), 10, 10)
        for path in (FusedQueryPath(enc, port_ix),
                     RefQuery(ref_encoder, ref_ix)))
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, atol=1e-4)
    # a page's own text finds it first
    assert [int(i) for i in got_i[:len(PAGES[::9]), 0]] == \
        list(range(0, len(PAGES), 9))


def test_node_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA node would start")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DawnNode(Config(device="cuda", data_dir=str(tmp_path)))


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_node_serves_over_http_and_reloads_its_snapshot(tree, vocab, tmp_path):
    cfg = Config(device="cpu", web=True, web_listen_address="127.0.0.1:0",
                 accept_insert=True, data_dir=str(tmp_path))
    node = DawnNode(cfg, encoder=port_encoder(tree, vocab)).start()
    try:
        base = f"http://127.0.0.1:{node.http_port}"
        pages = [{"url": f"https://n/{i}", "title": "", "text": t}
                 for i, t in enumerate(PAGES[:16])]
        assert len(_http(base + "/api/insert", {"pages": pages})["inserted"]) == 16
        first = _http(base + "/api/search?q=" + urllib.parse.quote(PAGES[3]))
        assert first["results"][0]["url"] == "https://n/3"
        prof = _http(base + "/api/profile?seconds=0.1")
        assert prof["trace_dir"] == os.path.join(str(tmp_path), "profile")
        assert os.path.getsize(prof["trace"]) > 0
        metrics = _http(base + "/api/metrics")
        assert metrics.get("kernel_bert_layer", 0) == 0  # CPU: plain only
    finally:
        node.stop()
    assert os.path.exists(tmp_path / "index.dawn.npz")
    node = DawnNode(cfg, encoder=port_encoder(tree, vocab)).start()
    try:
        assert isinstance(node.provider.index, FlatIndex)
        assert len(node.provider.index) == 16
        base = f"http://127.0.0.1:{node.http_port}"
        again = _http(base + "/api/search?q=" + urllib.parse.quote(PAGES[3]))
        assert [r["page_id"] for r in again["results"]] == \
            [r["page_id"] for r in first["results"]]
    finally:
        node.stop()


# packages the card's machine lacks (boto3 stays a lazy import of
# ingest/object_store.py's S3 store, transformers one of eval_quality.py's
# parity stage); msgpack, which net/packets.py needs, is installed there
CARD_LACKS = ("boto3", "botocore", "lxml", "transformers")


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port imports without JAX, the reference
    package, or a package the card's machine lacks."""
    code = ("import importlib, pkgutil, sys\n"
            "import dawnsearch_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    p.__path__, p.__name__ + '.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{('jax', 'jaxlib', 'dawnsearch_tpu', *CARD_LACKS)!r})\n"
            "print(len(mods), bad)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout
