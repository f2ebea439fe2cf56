"""The port's node on index_kind="sharded", and its sharded ingest path
against the reference's.

The first four cases are tests/test_node_sharded.py's on the port: 8
shards sharing the CPU (mesh_shards = 8; the reference's 8 virtual CPU
devices), a deterministic hash encoder. Then ShardedFusedIngestPath:
the same pages through the port's (plain twins on the CPU) and the
reference's (its K1 in interpret mode) into 8-shard i8 and i4 indexes
give the same embeddings (atol 5e-3, bf16 encoders), the same ids and
fill in every shard, codes equal to the port's own add of those
embeddings, and codes within one quantization step of the reference's.
"""

import hashlib
import json
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.node import DawnNode
from dawnsearch_tpu_torch.ops import quant
from dawnsearch_tpu_torch.parallel.mesh import make_mesh
from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex
from dawnsearch_tpu_torch.serving.fused import ShardedFusedIngestPath
from tests.test_torch_serving import (H, PAGES, port_encoder,  # noqa: F401
                                      ref_encoder, tree, vocab)

torch.set_num_threads(2)


class HashEncoder:
    """Deterministic stand-in for the model (node tests need no BERT)."""
    dim = 384

    def encode(self, texts):
        out = []
        for t in texts:
            seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4],
                                  "little")
            v = np.random.default_rng(seed).standard_normal(384).astype(
                np.float32)
            out.append(v / np.linalg.norm(v))
        return np.stack(out)


def get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def post_json(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _sharded_cfg(tmp_path, **kw):
    kw.setdefault("mesh_shards", 8)
    return Config(device="cpu", data_dir=str(tmp_path / "data"), web=True,
                  web_listen_address="127.0.0.1:0", index_kind="sharded",
                  **kw)


def test_sharded_node_end_to_end_and_persistence(tmp_path):
    cfg = _sharded_cfg(tmp_path)
    with DawnNode(cfg, encoder=HashEncoder()) as node:
        assert type(node.provider.index) is ShardedFlatIndex
        assert node.provider.index.n_shards == 8
        base = f"http://127.0.0.1:{node.http_port}"
        post_json(base + "/api/insert", {"pages": [
            {"url": f"https://e.com/{i}", "title": f"T{i}",
             "text": f"body {i}"} for i in range(20)]})
        data = get_json(base + "/api/search?q=T7%0Abody+7")
        assert data["results"][0]["url"] == "https://e.com/7"
        with urllib.request.urlopen(base + "/?q=T7%0Abody+7",
                                    timeout=30) as r:
            assert b"https://e.com/7" in r.read()
        assert get_json(base + "/api/stats")["pages_indexed"] == 20

    # restart on the same data dir: the sharded snapshot reloads
    with DawnNode(cfg, encoder=HashEncoder()) as node2:
        assert type(node2.provider.index) is ShardedFlatIndex
        base = f"http://127.0.0.1:{node2.http_port}"
        assert get_json(base + "/api/stats")["pages_indexed"] == 20
        data = get_json(base + "/api/search?q=T7%0Abody+7")
        assert data["results"][0]["url"] == "https://e.com/7"


def test_sharded_node_reshard_on_reload(tmp_path):
    # Save with 4 shards, reload with 8: rows re-stripe, and the
    # row_id -> store_id mapping must survive.
    cfg = _sharded_cfg(tmp_path, mesh_shards=4)
    with DawnNode(cfg, encoder=HashEncoder()) as node:
        assert node.provider.index.n_shards == 4
        base = f"http://127.0.0.1:{node.http_port}"
        post_json(base + "/api/insert", {"pages": [
            {"url": f"https://e.com/{i}", "title": f"T{i}",
             "text": f"body {i}"} for i in range(10)]})
    cfg.mesh_shards = 8
    with DawnNode(cfg, encoder=HashEncoder()) as node2:
        assert node2.provider.index.n_shards == 8
        base = f"http://127.0.0.1:{node2.http_port}"
        for i in (0, 4, 9):
            data = get_json(base + f"/api/search?q=T{i}%0Abody+{i}")
            assert data["results"][0]["url"] == f"https://e.com/{i}"


def test_sharded_index_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    # A sharded index on "cuda" with no visible card is refused by the
    # factory itself, not only by check_config; an empty mesh is refused.
    from dawnsearch_tpu_torch.node import make_index_factory
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cfg = _sharded_cfg(tmp_path, mesh_shards=0)
    cfg.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_index_factory(cfg)
    with pytest.raises(ValueError, match="no devices"):
        make_mesh({"shard": 0}, devices=[])


def test_sharded_bulk_add_is_vectorized(unit_vectors):
    # 100k rows through the striping path must take seconds, not the
    # minutes a per-row argmin loop would.
    idx = ShardedFlatIndex(mesh=make_mesh({"shard": 8}, devices=["cpu"] * 8),
                           dtype="i8", capacity_per_shard=16384,
                           segment=16384)
    rows = unit_vectors(100_000)
    t0 = time.perf_counter()
    ids = idx.add(rows)
    dt = time.perf_counter() - t0
    assert len(ids) == 100_000 and len(idx) == 100_000
    assert dt < 30.0, f"bulk add took {dt:.1f}s — striping regressed?"
    assert idx._counts.max() - idx._counts.min() <= 1
    d, u = idx.search(rows[:8], k=1)
    assert (u[:, 0] == ids[:8]).all()


def test_striping_matches_argmin_semantics(unit_vectors):
    # Water-filling reproduces the balance of a per-row argmin loop from
    # any skewed starting point.
    idx = ShardedFlatIndex(mesh=make_mesh({"shard": 8}, devices=["cpu"] * 8),
                           dtype="f32", capacity_per_shard=64, segment=64)
    idx._counts[:] = [13, 2, 7, 2, 0, 5, 1, 9]
    before = idx._counts.copy()
    n = 17
    idx.add(unit_vectors(n), ids=np.arange(n))
    ref = before.copy()
    for _ in range(n):
        ref[int(np.argmin(ref))] += 1
    assert (np.sort(idx._counts) == np.sort(ref)).all()
    assert int(idx._counts.sum()) == int(before.sum()) + n


@pytest.mark.parametrize("dtype,exact", [("i8", None), ("i8", "f16"),
                                         ("i4", None)])
def test_sharded_fused_ingest_matches_reference(tree, vocab, ref_encoder,
                                                dtype, exact):
    from dawnsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from dawnsearch_tpu.parallel.sharded_index import \
        ShardedFlatIndex as RefSharded
    from dawnsearch_tpu.serving.fused import \
        ShardedFusedIngestPath as RefIngest

    mesh = make_mesh({"shard": 8}, devices=["cpu"] * 8)
    kw = dict(dim=H, dtype=dtype, exact=exact, capacity_per_shard=64,
              segment=64)
    port_ix = ShardedFlatIndex(mesh=mesh, **kw)
    ref_ix = RefSharded(mesh=ref_make_mesh(devices=jax.devices()[:8]), **kw)
    port = ShardedFusedIngestPath(port_encoder(tree, vocab), port_ix)
    assert ShardedFusedIngestPath.supports(port_ix)
    ref = RefIngest(ref_encoder, ref_ix)
    parts = (PAGES[:20], PAGES[20:64])  # the second lands unaligned
    emb = np.concatenate([port.ingest(p) for p in parts])
    want = np.concatenate([ref.ingest(p) for p in parts])
    np.testing.assert_allclose(emb, want, atol=5e-3)
    np.testing.assert_array_equal(port_ix._counts, ref_ix._counts)
    assert port_ix._next_id == ref_ix._next_id == 64
    # the port's own host add of its embeddings writes the same rows
    host = ShardedFlatIndex(mesh=mesh, **kw)
    host.add(emb[:20])
    host.add(emb[20:])
    ref_ids = np.asarray(ref_ix._ids)
    for s in range(8):
        n = int(port_ix._counts[s])
        np.testing.assert_array_equal(port_ix._ids[0][s].numpy()[:n],
                                      ref_ids[s, :n])
        got, own = port_ix._codes[0][s].numpy(), host._codes[0][s].numpy()
        theirs = np.asarray(ref_ix._codes)[s]
        if dtype == "i4":
            got, own, theirs = (quant.unpack_i4_np(c, port_ix._i4_block)
                                for c in (got, own, theirs))
        np.testing.assert_array_equal(got[:n], own[:n])
        assert np.abs(got[:n].astype(int) - theirs[:n]).max() <= 1
        np.testing.assert_allclose(port_ix._scales[0][s].numpy()[:n],
                                   np.asarray(ref_ix._scales)[s, :n],
                                   rtol=1e-2)
        if exact:
            np.testing.assert_array_equal(port_ix._exact[0][s].numpy()[:n],
                                          host._exact[0][s].numpy()[:n])
    # and the ingested pages are found
    _, u = port_ix.search(emb[:8], 1)
    assert (u[:, 0] == np.arange(8)).all()


def test_sharded_node_ingests_through_the_sharded_path(tree, vocab, tmp_path):
    """A node with index_kind="sharded" and an encoder that tokenizes
    takes ShardedFusedIngestPath for /api/insert and answers text queries
    through the provider's sharded search (FusedQueryPath stays flat)."""
    cfg = _sharded_cfg(tmp_path, mesh_shards=4, accept_insert=True)
    with DawnNode(cfg, encoder=port_encoder(tree, vocab)) as node:
        assert isinstance(node.service._fused_ingest, ShardedFusedIngestPath)
        assert node.service._fused is None
        base = f"http://127.0.0.1:{node.http_port}"
        post_json(base + "/api/insert", {"pages": [
            {"url": f"https://s/{i}", "title": "", "text": t}
            for i, t in enumerate(PAGES[:24])]})
        assert list(node.provider.index._counts) == [6, 6, 6, 6]
        for i in (0, 11, 23):
            data = get_json(base + "/api/search?q="
                            + urllib.request.quote(PAGES[i]))
            assert data["results"][0]["url"] == f"https://s/{i}"
