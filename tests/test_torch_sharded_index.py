"""The port's ShardedFlatIndex on an 8-shard CPU mesh, and against the
reference's on the same rows.

The first 21 cases are tests/test_sharded_index.py's, on the port: 8
shards sharing the CPU device (the reference's 8 virtual CPU devices).
The legacy i4 snapshot case becomes a refusal (the port does not migrate
the pre-row-block layout; the provider rebuilds from the store). Then
the cross-package cases: the same seeded rows in both packages' sharded
indexes give equal ids and distances (f32 atol 1e-5 with ids compared as
sets per row; the quantized tiers equal ids at atol 2e-5 on queries near
stored rows, as tests/test_torch_flat_index.py holds the flat index),
the per-shard select's plain twin with the gate lowered, and snapshots
written by either package loading in the other on the same shard count
and re-striped.
"""

import numpy as np
import pytest
import torch

from dawnsearch_tpu.parallel.mesh import make_mesh as ref_make_mesh
from dawnsearch_tpu.parallel.sharded_index import \
    ShardedFlatIndex as RefSharded
from dawnsearch_tpu_torch.index import load_index
from dawnsearch_tpu_torch.index.flat import FlatIndex, IndexFull
from dawnsearch_tpu_torch.parallel.mesh import make_mesh
from dawnsearch_tpu_torch.parallel.sharded_index import (ShardedFlatIndex,
                                                         merge_shards)

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"shard": 8}, devices=CPU8)


def brute_force(q, x, k):
    d = 1.0 - q @ x.T
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


def test_mesh_has_8_shards(mesh):
    assert mesh.shape["shard"] == 8
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh({"shard": 4}, devices=["cpu"] * 3)


def test_exact_recall_f32(mesh, unit_vectors):
    x = unit_vectors(1000)
    q = unit_vectors(5)
    idx = ShardedFlatIndex(mesh=mesh, dtype="f32",
                           capacity_per_shard=256, segment=256)
    ids = idx.add(x)
    np.testing.assert_array_equal(ids, np.arange(1000))
    d, u = idx.search(q, 10)
    bd, bu = brute_force(q, x, 10)
    recall = np.mean([len(set(u[b]) & set(bu[b])) / 10 for b in range(5)])
    assert recall == 1.0
    np.testing.assert_allclose(np.sort(d, axis=1), d, atol=0)  # ascending


def test_self_match(mesh, unit_vectors):
    x = unit_vectors(64)
    idx = ShardedFlatIndex(mesh=mesh, dtype="f32",
                           capacity_per_shard=64, segment=64)
    idx.add(x)
    d, u = idx.search(x, 1)
    np.testing.assert_array_equal(u[:, 0], np.arange(64))
    assert np.all(d[:, 0] < 1e-3)


def test_balanced_striping(mesh, unit_vectors):
    idx = ShardedFlatIndex(mesh=mesh, dtype="f32",
                           capacity_per_shard=64, segment=64)
    idx.add(unit_vectors(100))
    assert idx._counts.max() - idx._counts.min() <= 1


def test_growth_preserves_results(mesh, unit_vectors):
    idx = ShardedFlatIndex(mesh=mesh, dtype="f32",
                           capacity_per_shard=64, segment=64)
    x1 = unit_vectors(300)
    idx.add(x1)
    cap_before = idx.cap_per_shard
    idx.add(unit_vectors(2000))
    assert idx.cap_per_shard > cap_before
    d, u = idx.search(x1[42], 1)
    assert u[0] == 42 and d[0] < 1e-3


def test_i8_sharded_recall(mesh, unit_vectors):
    x = unit_vectors(2000)
    q = unit_vectors(6)
    idx = ShardedFlatIndex(mesh=mesh, dtype="i8",
                           capacity_per_shard=256, segment=256)
    idx.add(x)
    _, u = idx.search(q, 10)
    _, bu = brute_force(q, x, 10)
    recall = np.mean([len(set(u[b]) & set(bu[b])) / 10 for b in range(6)])
    assert recall >= 0.9, recall


def test_partial_fill_masks_invalid(mesh, unit_vectors):
    idx = ShardedFlatIndex(mesh=mesh, dtype="f32",
                           capacity_per_shard=64, segment=64)
    idx.add(unit_vectors(3))  # fewer rows than shards
    d, u = idx.search(unit_vectors(1), 10)
    assert (u >= 0).sum() == 3
    assert np.all(np.isinf(d[0, 3:]))


def test_user_ids_survive(mesh, unit_vectors):
    idx = ShardedFlatIndex(mesh=mesh, dtype="f32",
                           capacity_per_shard=64, segment=64)
    x = unit_vectors(10)
    idx.add(x, ids=np.arange(100, 110))
    _, u = idx.search(x[4], 1)
    assert u[0] == 104


def test_single_device_mesh_works(unit_vectors):
    mesh1 = make_mesh(devices=["cpu"])
    idx = ShardedFlatIndex(mesh=mesh1, dtype="f32",
                           capacity_per_shard=64, segment=64)
    x = unit_vectors(50)
    idx.add(x)
    _, u = idx.search(x[7], 3)
    assert u[0] == 7


def test_matches_unsharded(mesh, unit_vectors):
    x = unit_vectors(512)
    q = unit_vectors(4)
    sh = ShardedFlatIndex(mesh=mesh, dtype="f32",
                          capacity_per_shard=64, segment=64)
    fl = FlatIndex(dtype="f32", capacity=512, segment=512, device="cpu")
    sh.add(x)
    fl.add(x)
    ds, us = sh.search(q, 10)
    df, uf = fl.search(q, 10)
    np.testing.assert_allclose(ds, df, atol=1e-5)
    for b in range(4):
        assert set(us[b]) == set(uf[b])


def test_save_load_same_mesh(mesh, tmp_path, unit_vectors):
    x = unit_vectors(100)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", capacity_per_shard=64,
                          segment=64)
    ix.add(x)
    p = str(tmp_path / "sh.npz")
    ix.save(p)
    ld = load_index(p, mesh=mesh)
    assert isinstance(ld, ShardedFlatIndex)
    assert len(ld) == 100 and ld.capacity == ix.capacity
    d0, i0 = ix.search(x[:8], 5)
    d1, i1 = ld.search(x[:8], 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, atol=1e-6)
    # post-load adds continue the id sequence
    new = ld.add(unit_vectors(3))
    assert new.min() == 100


def test_save_load_restripe(mesh, tmp_path, unit_vectors):
    """Reload onto a mesh with a different shard count."""
    x = unit_vectors(64)
    ix = ShardedFlatIndex(mesh=mesh, dtype="f32", capacity_per_shard=32,
                          segment=32)
    ix.add(x)
    p = str(tmp_path / "sh8.npz")
    ix.save(p)
    ld = ShardedFlatIndex.load(p, mesh=make_mesh({"shard": 2},
                                                 devices=["cpu"] * 2))
    assert ld.n_shards == 2 and len(ld) == 64
    d, i = ld.search(x[:8], 1)
    np.testing.assert_array_equal(i[:, 0], np.arange(8))
    assert np.all(d[:, 0] < 1e-5)


def test_dp_sharded_queries(unit_vectors):
    """2D mesh: rows shard over "shard", query batch splits over "dp"."""
    mesh = make_mesh({"dp": 2, "shard": 4}, devices=CPU8)
    ix = ShardedFlatIndex(mesh=mesh, dtype="f32", capacity_per_shard=64,
                          segment=64, dp_axis="dp")
    x = unit_vectors(100)
    ids = ix.add(x)
    # batch not divisible by dp degree exercises the padding path
    d, u = ix.search(x[:7], k=3)
    assert d.shape == (7, 3)
    np.testing.assert_array_equal(u[:, 0], ids[:7])
    assert np.all(d[:, 0] < 1e-5)
    # each query group holds its own replica of the row shards
    assert len(ix._codes) == 2 and len(ix._codes[0]) == 4
    torch.testing.assert_close(ix._codes[0][1], ix._codes[1][1])
    # replicated-query mode still works on the same 2D mesh
    ix2 = ShardedFlatIndex(mesh=mesh, dtype="i8", capacity_per_shard=64,
                           segment=64)
    ix2.add(x)
    d2, u2 = ix2.search(x[:5], k=1)
    np.testing.assert_array_equal(u2[:, 0], np.arange(5))


def test_sharded_device_rerank_exact_order(mesh, unit_vectors):
    """Per-shard f16 re-rank before the merge: global top-k comes back
    exact-ordered at i8 memory + 2 bytes/dim."""
    x = unit_vectors(2000)
    q = unit_vectors(8)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", exact="f16",
                          capacity_per_shard=512, segment=256, chunk=256)
    assert ix.device_rerank
    ix.add(x)
    d, u = ix.search(q, 10)
    ref = 1.0 - q @ x.T
    bi = np.argsort(ref, axis=1, kind="stable")[:, :10]
    hits = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(u, bi)])
    assert hits >= 0.99
    bd = np.take_along_axis(ref, bi, axis=1)
    np.testing.assert_allclose(d, bd, atol=2e-3)
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_sharded_device_rerank_save_load(mesh, tmp_path, unit_vectors):
    x = unit_vectors(300)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", exact="f16",
                          capacity_per_shard=128, segment=64, chunk=64)
    ix.add(x)
    p = str(tmp_path / "sharded.npz")
    ix.save(p)
    ix2 = ShardedFlatIndex.load(p, mesh=mesh)
    assert ix2.device_rerank and len(ix2) == 300
    d1, u1 = ix.search(x[:4], 5)
    d2, u2 = ix2.search(x[:4], 5)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_allclose(d1, d2, atol=1e-6)


def test_sharded_fused_selector(mesh, unit_vectors):
    """Per-shard score+select (K2's plain twin on the CPU; the gate
    lowered for the test)."""
    x = unit_vectors(4096)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", exact="f16",
                          capacity_per_shard=16384, segment=16384)
    ix.fused_min_rows = 0
    ix.add(x)
    assert ix.fused_eligible()
    d, u = ix.search(x[:8], 5)
    assert (u[:, 0] == np.arange(8)).all()
    assert np.all(d[:, 0] < 1e-2)
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_add_at_max_capacity_uses_free_shards(mesh, unit_vectors):
    """Near an aligned max_capacity, rows that fit on the least-full
    shards must land there."""
    x = unit_vectors(64)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", capacity_per_shard=8,
                          segment=8, max_capacity=64)
    ix.add(x[:63])  # counts [8]*7 + [7]
    assert int(ix._counts.max()) == 8 and int(ix._counts.min()) == 7
    ids = ix.add(x[63])  # one free slot on the min shard
    assert len(ix) == 64 and ids[0] == 63
    d, u = ix.search(x[63], 1)
    assert u[0] == 63 and d[0] < 1e-2
    with pytest.raises(IndexFull, match="full"):
        ix.add(x[:1])


def test_add_at_max_capacity_partial_room(mesh, unit_vectors):
    """A batch larger than any single shard's room still fits when the
    total free slots cover it (capped re-plan spreads it)."""
    x = unit_vectors(64)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", capacity_per_shard=8,
                          segment=8, max_capacity=64)
    ix.add(x[:58])
    ix.add(x[58:64])
    assert len(ix) == 64
    d, u = ix.search(x[60], 1)
    assert u[0] == 60 and d[0] < 1e-2
    # every row is findable (no clobbered rows)
    d, u = ix.search(x, 1)
    assert (u[:, 0] == np.arange(64)).all()


def test_sharded_load_backfills_exact(mesh, unit_vectors, tmp_path):
    """Requesting exact="f16" on a snapshot without the shadow buffer
    backfills it from dequantized codes (an all-zero shadow would make
    every re-ranked distance 1.0)."""
    x = unit_vectors(200)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i8", capacity_per_shard=64,
                          segment=64)
    ix.add(x)
    p = str(tmp_path / "noexact.npz")
    ix.save(p)
    ix2 = ShardedFlatIndex.load(p, mesh=mesh, exact="f16")
    assert ix2.device_rerank
    d, u = ix2.search(x[:8], 5)
    assert (u[:, 0] == np.arange(8)).all()
    assert np.all(d[:, 0] < 1e-2)


def test_sharded_legacy_i4_snapshot_is_refused(mesh, unit_vectors, tmp_path):
    """A pre-row-block sharded i4 snapshot ((S, cap, D/2) dim-plane
    nibbles, no i4_block key) is refused with a clear error, and the
    provider's load_index path raises the same, so it rebuilds from the
    page store (the reference migrates it; the port leaves that behind)."""
    from dawnsearch_tpu_torch.ops.quant import quantize_i4_vals_np

    S, cap, n_per = 8, 64, 32
    x = unit_vectors(S * n_per)
    vals, scales = quantize_i4_vals_np(x)
    codes = np.zeros((S, cap, 192), np.uint8)
    sc = np.ones((S, cap), np.float32)
    ids = np.full((S, cap), -1, np.int64)
    for s in range(S):
        v = vals[s * n_per:(s + 1) * n_per]
        codes[s, :n_per] = v[:, :192] | (v[:, 192:] << 4)
        sc[s, :n_per] = scales[s * n_per:(s + 1) * n_per]
        ids[s, :n_per] = np.arange(s * n_per, (s + 1) * n_per)
    p = str(tmp_path / "legacy_sharded.npz")
    np.savez(p, kind="sharded", codes=codes, scales=sc, exact=np.empty(0),
             ids=ids, counts=np.full(S, n_per, np.int64), next_id=S * n_per,
             dtype="i4", dim=384)
    with pytest.raises(ValueError, match="legacy"):
        ShardedFlatIndex.load(p, mesh=mesh)
    with pytest.raises(ValueError, match="page store"):
        load_index(p, mesh=mesh)


def test_sharded_i4_snapshot_block_repack(mesh, unit_vectors, tmp_path):
    """A snapshot written with one i4 packing block reloads under a
    different segment (hence block) through the repack branch, with
    identical search results."""
    x = unit_vectors(256)
    ix = ShardedFlatIndex(mesh=mesh, dtype="i4", capacity_per_shard=64,
                          segment=64)
    ix.add(x)
    d1, u1 = ix.search(x[:8], 5)
    p = str(tmp_path / "b64.npz")
    ix.save(p)
    ix2 = ShardedFlatIndex.load(p, mesh=mesh, segment=32)
    assert ix2._i4_block == 32 and ix._i4_block == 64
    d2, u2 = ix2.search(x[:8], 5)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_allclose(d1, d2, atol=1e-6)


# -- against the reference package ------------------------------------------

N, NQ, K = 3000, 16, 10


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(0)

    def unit(n):
        v = rng.standard_normal((n, 384), np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    x = unit(N)
    # queries near stored rows, so the top ids are well separated
    q = x[rng.integers(0, N, NQ)] + 0.3 * unit(NQ)
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _pair(mesh, dtype, exact=None, **kw):
    return (RefSharded(mesh=ref_make_mesh(), dtype=dtype, exact=exact, **kw),
            ShardedFlatIndex(mesh=mesh, dtype=dtype, exact=exact, **kw))


@pytest.mark.parametrize("dtype,exact", [
    ("f32", None), ("bf16", None), ("i8", None), ("i8", "f16"),
    ("i4", None), ("i4", "f16")])
def test_search_matches_reference(mesh, vecs, dtype, exact):
    x, q = vecs
    ref, port = _pair(mesh, dtype, exact, capacity_per_shard=256,
                      segment=256)
    np.testing.assert_array_equal(ref.add(x[:1700]), port.add(x[:1700]))
    ref.add(x[1700:], ids=np.arange(5000, 5000 + N - 1700))
    port.add(x[1700:], ids=np.arange(5000, 5000 + N - 1700))
    np.testing.assert_array_equal(ref._counts, port._counts)
    assert ref.cap_per_shard == port.cap_per_shard
    want_d, want_u = ref.search(q, K)
    got_d, got_u = port.search(q, K)
    for b in range(NQ):
        assert set(got_u[b]) == set(want_u[b])
    np.testing.assert_allclose(got_d, want_d, atol=1e-5 if dtype == "f32"
                               else 2e-5)
    if dtype != "f32":
        np.testing.assert_array_equal(got_u, want_u)
    d1, u1 = port.search(q[0], K)  # the single-query form
    np.testing.assert_array_equal(u1, got_u[0])


@pytest.mark.parametrize("exact", [None, "f16"])
def test_per_shard_select_matches_reference(mesh, vecs, exact):
    """The gate lowered (fused_min_rows = 0): each shard runs K2's plain
    twin here and the reference's Pallas select (interpret mode) there;
    raw candidates and the f16 re-rank give the same ids."""
    x, q = vecs
    ref, port = _pair(mesh, "i8", exact, capacity_per_shard=16384,
                      segment=16384)
    ref.fused_min_rows = port.fused_min_rows = 0
    ref.add(x)
    port.add(x)
    assert port.fused_eligible()
    want_d, want_u = ref.search(q, K)
    got_d, got_u = port.search(q, K)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_allclose(got_d, want_d, atol=2e-5)


def test_merge_keeps_the_lowest_shard_first_on_ties():
    """Equal distances across shards resolve to the lowest shard-major
    column, as the reference's lax.top_k over its all_gather."""
    d = torch.tensor([[[0.5, 0.7]], [[0.5, 0.6]], [[0.2, 0.5]]])
    u = torch.tensor([[[10, 11]], [[20, 21]], [[30, 31]]], dtype=torch.int32)
    vals, ids = merge_shards(d, u, 4)
    assert ids.tolist() == [[30, 10, 20, 31]]
    np.testing.assert_allclose(vals.numpy(), [[0.2, 0.5, 0.5, 0.5]])


@pytest.mark.parametrize("dtype,exact", [("f32", None), ("i8", None),
                                         ("i8", "f16"), ("i4", None)])
def test_snapshot_written_by_reference_loads_in_port(mesh, vecs, tmp_path,
                                                     dtype, exact):
    x, q = vecs
    ref, _ = _pair(mesh, dtype, exact, capacity_per_shard=256, segment=256)
    ref.add(x)
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    want_d, want_u = ref.search(q, K)
    port = load_index(path, mesh=mesh, exact=exact)
    assert isinstance(port, ShardedFlatIndex) and len(port) == N
    got_d, got_u = port.search(q, K)
    np.testing.assert_array_equal(got_u, want_u)
    np.testing.assert_allclose(got_d, want_d, atol=2e-5)
    # re-striped onto 3 shards: the same rows under the same user ids
    three = load_index(path, mesh=make_mesh({"shard": 3},
                                            devices=["cpu"] * 3), exact=exact)
    assert three.n_shards == 3 and len(three) == N
    _, u3 = three.search(q, K)
    assert (u3[:, 0] == want_u[:, 0]).all()


@pytest.mark.parametrize("dtype,exact", [("f32", None), ("i8", None),
                                         ("i8", "f16"), ("i4", None)])
def test_snapshot_written_by_port_loads_in_reference(mesh, vecs, tmp_path,
                                                     dtype, exact):
    from dawnsearch_tpu.index import load_index as ref_load

    x, q = vecs
    ref, port = _pair(mesh, dtype, exact, capacity_per_shard=256, segment=256)
    ref.add(x)
    port.add(x)
    pp, rp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    port.save(pp)
    ref.save(rp)
    with np.load(pp) as a, np.load(rp) as b:  # the reference's bytes
        assert set(a.files) == set(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    loaded = ref_load(pp)
    assert isinstance(loaded, RefSharded) and len(loaded) == N
    np.testing.assert_array_equal(loaded.search(q, K)[1], port.search(q, K)[1])
    import jax
    two = RefSharded.load(pp, mesh=ref_make_mesh({"shard": 2},
                                                 devices=jax.devices()[:2]))
    assert two.n_shards == 2
    assert (two.search(q, K)[1][:, 0] == port.search(q, K)[1][:, 0]).all()


def test_bf16_snapshot_is_byte_equal_to_reference(mesh, vecs, tmp_path):
    x, _ = vecs
    ref, port = _pair(mesh, "bf16", capacity_per_shard=256, segment=256)
    ref.add(x[:500])
    port.add(x[:500])
    pp, rp = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    port.save(pp)
    ref.save(rp)
    import zipfile
    with zipfile.ZipFile(pp) as a, zipfile.ZipFile(rp) as b:
        assert a.read("codes.npy") == b.read("codes.npy")
    q = x[:4]
    np.testing.assert_array_equal(load_index(pp, mesh=mesh).search(q, 5)[1],
                                  port.search(q, 5)[1])
