"""The port's FlatIndex vs the reference's on the same vectors.

Both indexes get the same seeded unit vectors and queries. For every
storage dtype (f32, bf16, i8 and the i4 capacity tier) the chunked exact
path, the fused selector path (K2's or K3's plain twin here; its gate
lowered with fused_min_rows = 0, as the reference's tests do) and the f16
device re-rank must return the same ids; growth, IndexFull, the unit-query
guard and the capacity guard behave the same; i4 buffers hold the
reference's bytes whichever way rows were added; and snapshots written by
either package load into the other and search to the same ids (bf16: the
reference cannot reload its own snapshot, so only the port loads them).
"""

import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.index.flat import FlatIndex as RefIndex
from dawnsearch_tpu.index.flat import IndexFull as RefIndexFull
from dawnsearch_tpu_torch.index import load_index
from dawnsearch_tpu_torch.index.flat import FlatIndex, IndexFull
from dawnsearch_tpu_torch.ops import quant, scan_select

torch.set_num_threads(2)

N, NQ, K = 3000, 16, 10


def _unit(rng, n, dim=384):
    v = rng.standard_normal((n, dim), np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(0)
    x = _unit(rng, N)
    # queries near stored rows, so the top ids are well separated
    q = x[rng.integers(0, N, NQ)] + 0.3 * _unit(rng, NQ)
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _pair(dtype, exact=None, fused=False, **kw):
    ref = RefIndex(dtype=dtype, exact=exact, **kw)
    port = FlatIndex(dtype=dtype, exact=exact, device="cpu", **kw)
    if fused:
        ref.fused_min_rows = port.fused_min_rows = 0
    return ref, port


@pytest.mark.parametrize("dtype,exact,fused", [
    ("f32", None, False), ("i8", None, False), ("i8", "f16", False),
    ("i8", None, True), ("i8", "f16", True),
    ("bf16", None, False), ("bf16", None, True),
    ("i4", None, False), ("i4", "f16", False),
    ("i4", None, True), ("i4", "f16", True)])
def test_search_matches_reference(vecs, dtype, exact, fused):
    x, q = vecs
    ref, port = _pair(dtype, exact, fused)
    ref.add(x)
    port.add(x)
    assert port.fused_eligible() == fused
    want_d, want_i = ref.search(q, K)
    got_d, got_i = port.search(q, K)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, atol=2e-5)
    # single-query form and device-tensor input agree with the batch
    d1, i1 = port.search(q[0], K)
    np.testing.assert_array_equal(i1, got_i[0])
    d2, i2 = port.search(torch.from_numpy(q), K)
    np.testing.assert_array_equal(i2, got_i)


def test_tensor_add_quantizes_like_numpy_add(vecs):
    x, q = vecs
    a = FlatIndex(dtype="i8", exact="f16", device="cpu")
    b = FlatIndex(dtype="i8", exact="f16", device="cpu")
    a.add(x)
    b.add(torch.from_numpy(x))
    assert torch.equal(a._codes, b._codes) and torch.equal(a._scales, b._scales)
    assert torch.equal(a._exact, b._exact)


def test_growth_and_index_full_match_reference(vecs):
    x, _ = vecs
    ref, port = _pair("i8", capacity=16384, max_capacity=40000)
    for n in (10000, 10000, 15000):
        ref.add(np.resize(x, (n, 384)))
        port.add(np.resize(x, (n, 384)))
        assert (port.capacity, port.count) == (ref.capacity, ref.count)
    assert port.capacity == 49152  # min(round_up(40000), doubled)
    with pytest.raises(RefIndexFull):
        ref.add(np.resize(x, (20000, 384)))
    with pytest.raises(IndexFull):
        port.add(np.resize(x, (20000, 384)))
    assert port.count == ref.count == 35000


def test_rejects_non_unit_queries_when_fused(vecs):
    x, q = vecs
    ref, port = _pair("i8", fused=True)
    ref.add(x)
    port.add(x)
    for idx in (ref, port):
        with pytest.raises(ValueError, match="normalized"):
            idx.search(q * 1.5, K)
    # below the gate the chunked path serves non-unit queries
    port.fused_min_rows = scan_select.MIN_ROWS
    assert port.search(q * 1.5, K)[1].shape == (NQ, K)


def test_fused_path_needs_whole_tiles(vecs):
    x, q = vecs
    ref, port = _pair("i8", fused=True, capacity=4096, segment=4096)
    ref.add(x)
    port.add(x)
    assert not scan_select.eligible(port.count, port.capacity, port.dim,
                                    port.dtype, 0)
    np.testing.assert_array_equal(port.search(q, K)[1], ref.search(q, K)[1])
    with pytest.raises(ValueError, match="capacity"):
        scan_select.search_select(port._codes, port._scales,
                                  torch.from_numpy(q), port.count, K)


def test_refuses_unported_dtypes():
    """Every storage dtype of the reference is served; a dtype it lacks is
    refused by both packages."""
    for dtype in ("f16", "i2"):
        with pytest.raises(ValueError, match="unsupported dtype"):
            FlatIndex(dtype=dtype, device="cpu")
        with pytest.raises(ValueError):
            RefIndex(dtype=dtype)
    for dtype in ("f32", "bf16", "i8", "i4"):
        assert FlatIndex(dtype=dtype, device="cpu").dtype == dtype
    with pytest.raises(ValueError, match="even dim"):
        FlatIndex(dim=383, dtype="i4", device="cpu")


@pytest.mark.parametrize("exact", [None, "f16"])
def test_reference_snapshot_loads_into_port(vecs, tmp_path, exact):
    x, q = vecs
    ref, _ = _pair("i8", exact)
    ref.add(x)
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    port = load_index(path, device="cpu", max_capacity=1_000_000)
    assert (port.count, port.capacity, port.dtype) == (ref.count,
                                                       ref.capacity, "i8")
    assert port.device_rerank == (exact is not None)
    np.testing.assert_array_equal(port.search(q, K)[1], ref.search(q, K)[1])
    np.testing.assert_array_equal(port._codes.numpy(), np.asarray(ref._codes))


@pytest.mark.parametrize("exact", [None, "f16"])
def test_port_snapshot_loads_into_reference(vecs, tmp_path, exact):
    from dawnsearch_tpu.index import load_index as ref_load

    x, q = vecs
    _, port = _pair("i8", exact)
    port.add(x)
    path = str(tmp_path / "port.npz")
    port.save(path)
    ref = ref_load(path, max_capacity=1_000_000)
    assert (ref.count, ref.capacity, ref.dtype) == (port.count,
                                                    port.capacity, "i8")
    assert ref.device_rerank == (exact is not None)
    np.testing.assert_array_equal(ref.search(q, K)[1], port.search(q, K)[1])
    np.testing.assert_array_equal(np.asarray(ref._scales), port._scales.numpy())


def test_load_backfills_a_requested_shadow(vecs, tmp_path):
    x, q = vecs
    ref, _ = _pair("i8")
    ref.add(x)
    path = str(tmp_path / "plain.npz")
    ref.save(path)
    port = FlatIndex.load(path, exact="f16", device="cpu")
    want = RefIndex.load(path, exact="f16")
    np.testing.assert_array_equal(port._exact.numpy(),
                                  np.asarray(want._exact))
    np.testing.assert_array_equal(port.search(q, K)[1], want.search(q, K)[1])


def test_rerank_kernel_matches_reference(vecs):
    from dawnsearch_tpu.index.flat import rerank_kernel as ref_rerank
    from dawnsearch_tpu_torch.index.flat import rerank_kernel

    x, q = vecs
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, N, (NQ, 40)).astype(np.int32)
    dists = rng.random((NQ, 40)).astype(np.float32)
    dists[ids < 0] = np.inf
    exact = x.astype(np.float16)
    want = ref_rerank(jnp.asarray(exact), jnp.asarray(q), jnp.asarray(dists),
                      jnp.asarray(ids), K)
    got = rerank_kernel(torch.from_numpy(exact), torch.from_numpy(q),
                        torch.from_numpy(dists), torch.from_numpy(ids), K)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)


def _logical_i4(index, count):
    """Biased-free i4 codes of the first `count` logical rows."""
    return quant.unpack_i4_np(np.asarray(index._codes),
                              index._i4_block)[:count]


def test_i4_growth_matches_reference(vecs):
    """Adds that are not whole blocks take the read-modify-write, across
    two growths; the packed buffer and the scales equal the reference's."""
    x, q = vecs
    ref, port = _pair("i4", capacity=256, max_capacity=2000, segment=256)
    assert port._i4_block == ref._i4_block == 256
    s = 0
    for n in (100, 300, 700):
        ref.add(x[s:s + n])
        port.add(x[s:s + n])
        s += n
        assert (port.capacity, port.count) == (ref.capacity, ref.count)
        assert tuple(port._codes.shape) == (port.capacity // 2, 384)
        np.testing.assert_array_equal(port._codes.numpy(), np.asarray(ref._codes))
        np.testing.assert_array_equal(port._scales.numpy(),
                                      np.asarray(ref._scales))
    assert port.nbytes == ref.nbytes
    with pytest.raises(IndexFull):
        port.add(x[s:s + 1000])
    np.testing.assert_array_equal(port.search(q, K)[1], ref.search(q, K)[1])


def test_i4_prepacked_add_equals_read_modify_write(vecs):
    """Host adds of whole blocks are packed on the host and land straight
    in at a block-aligned count; a misaligned one unpacks and merges; a
    tensor add quantizes on the device and always merges. All three give
    the same buffer as the reference's add."""
    x, _ = vecs
    steps = (512, 100, 256, 44, 512)  # 256-row blocks: packed, RMW, ...
    host, dev = (FlatIndex(dtype="i4", segment=256, device="cpu")
                 for _ in range(2))
    ref = RefIndex(dtype="i4", segment=256)
    s = 0
    for n in steps:
        part = x[s:s + n]
        host.add(part)
        dev.add(torch.from_numpy(part))
        ref.add(part)
        s += n
    np.testing.assert_array_equal(host._codes.numpy(), dev._codes.numpy())
    np.testing.assert_array_equal(host._codes.numpy(), np.asarray(ref._codes))
    np.testing.assert_array_equal(host._scales.numpy(), dev._scales.numpy())
    want, _ = quant.quantize_i4_vals_np(x[:s])
    np.testing.assert_array_equal(_logical_i4(host, s), want.astype(np.int8) - 8)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("exact", [None, "f16"])
def test_i4_snapshot_crosses_both_ways(vecs, tmp_path, writer, exact):
    from dawnsearch_tpu.index import load_index as ref_load

    x, q = vecs
    ref, port = _pair("i4", exact)
    src = ref if writer == "reference" else port
    src.add(x)
    path = str(tmp_path / "i4.npz")
    src.save(path)
    with np.load(path) as z:
        assert int(z["i4_block"]) == quant.I4_BLOCK
        assert z["codes"].dtype == np.uint8
        assert z["codes"].shape == (src.capacity // 2, 384)
        assert z["scales"].shape == (src.capacity,)
    got = (load_index(path, device="cpu") if writer == "reference"
           else ref_load(path))
    assert (got.count, got.capacity, got.dtype) == (src.count, src.capacity,
                                                    "i4")
    assert got.device_rerank == (exact is not None)
    np.testing.assert_array_equal(np.asarray(got._codes),
                                  np.asarray(src._codes))
    np.testing.assert_array_equal(got.search(q, K)[1], src.search(q, K)[1])


def test_i4_snapshot_under_another_block_repacks(vecs, tmp_path):
    """A snapshot packed in 256-row blocks loads into an index of the
    default segment (16,384-row blocks) by repacking, as the reference."""
    x, q = vecs
    ref = RefIndex(dtype="i4", segment=256)
    ref.add(x)
    path = str(tmp_path / "small.npz")
    ref.save(path)
    port = FlatIndex.load(path, device="cpu")
    want = RefIndex.load(path)
    assert port._i4_block == want._i4_block == quant.I4_BLOCK
    assert port.capacity == want.capacity == 16384
    np.testing.assert_array_equal(port._codes.numpy(), np.asarray(want._codes))
    np.testing.assert_array_equal(port._scales.numpy(),
                                  np.asarray(want._scales))
    np.testing.assert_array_equal(port.search(q, K)[1], ref.search(q, K)[1])


def test_legacy_i4_snapshot_is_refused(vecs, tmp_path):
    """i4_block 0 marks the reference's old per-row dim-plane layout; the
    port does not migrate it, and the provider rebuilds from the store."""
    x, _ = vecs
    vals, scales = quant.quantize_i4_vals_np(x)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, codes=(vals[:, :192] | (vals[:, 192:] << 4)),
             scales=scales, exact=np.empty(0), count=len(x), dtype="i4",
             dim=384, i4_block=0)
    with pytest.raises(ValueError, match="page store"):
        FlatIndex.load(path, device="cpu")
    assert RefIndex.load(path).count == len(x)  # the reference migrates


def _bf16_snapshots(vecs, tmp_path):
    x, _ = vecs
    ref, port = _pair("bf16")
    ref.add(x)
    port.add(x)
    paths = [str(tmp_path / f"{n}.npz") for n in ("ref", "port")]
    ref.save(paths[0])
    port.save(paths[1])
    return ref, paths


def test_bf16_reference_snapshot_loads_into_port(vecs, tmp_path):
    x, q = vecs
    ref, (ref_path, _) = _bf16_snapshots(vecs, tmp_path)
    port = load_index(ref_path, device="cpu")
    assert (port.count, port.capacity, port.dtype) == (ref.count,
                                                       ref.capacity, "bf16")
    assert port._codes.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port._codes.view(torch.int16).numpy(),
        np.asarray(ref._codes).view(np.int16))
    np.testing.assert_array_equal(port.search(q, K)[1], ref.search(q, K)[1])


def test_bf16_port_snapshot_is_byte_equal_to_reference(vecs, tmp_path):
    """Every member of the two archives holds the same bytes. Neither
    archive reloads in the reference: numpy reads bf16 back as void
    (ROADMAP.md Queue 3); the port reads it as 16-bit patterns."""
    _, q = vecs
    _, paths = _bf16_snapshots(vecs, tmp_path)
    zips = [zipfile.ZipFile(p) for p in paths]
    try:
        names = sorted(zips[0].namelist())
        assert names == sorted(zips[1].namelist())
        for name in names:
            assert zips[0].read(name) == zips[1].read(name), name
    finally:
        for z in zips:
            z.close()
    for path in paths:
        with pytest.raises(ValueError):
            RefIndex.load(path)
    a, b = (FlatIndex.load(p, device="cpu") for p in paths)
    np.testing.assert_array_equal(a.search(q, K)[1], b.search(q, K)[1])


def test_i4_device_rerank_fetch_width_takes_the_ladder(vecs):
    x, _ = vecs
    ref, port = _pair("i4", "f16")
    for idx in (ref, port):
        idx.add(x)
    for k in (10, 50, 100):
        assert port.device_fetch_width(k) == ref.device_fetch_width(k)
    assert port.device_fetch_width(10) == 64  # not k + 30
    _, i8 = _pair("i8", "f16")
    assert i8.device_fetch_width(10) == 40


@pytest.mark.parametrize("dtype", ["f32", "bf16", "i8", "i4"])
def test_provider_fetch_width_matches_reference(dtype):
    from dawnsearch_tpu.index.provider import SearchProvider as RefProvider
    from dawnsearch_tpu_torch.index.provider import SearchProvider

    ref = RefProvider(data_dir=None, dim=384, verify_on_load=False,
                      index_factory=lambda: RefIndex(dtype=dtype))
    port = SearchProvider(
        data_dir=None, dim=384, verify_on_load=False, device="cpu",
        index_factory=lambda: FlatIndex(dtype=dtype, device="cpu"))
    # the i4 ladder keys on the row count; no rows need to be stored
    for count in (0, 500_001, 2_000_001, 8_000_001):
        ref.index.count = port.index.count = count
        for k in (10, 100, 600):
            assert port.fetch_width(k) == ref.fetch_width(k), (count, k)
    if dtype == "i4":
        assert port.fetch_width(10) == 512
