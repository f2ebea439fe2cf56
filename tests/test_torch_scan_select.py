"""K2 and K3: the port's score+select plain twins vs the reference kernels.

The reference's `_candidates` (K2) and `_candidates_i4` (K3) run their
Pallas kernels in interpret mode on the CPU; the port's
`select_candidates_plain` gets the same seeded codes, scales and queries.
The window partition, the packed-key tie rule, the count mask and the
epilogue rounding are all part of the contract, so with i8 queries the
candidate values must match bit for bit where the math is exact (see
test_candidates_match_reference). With bf16 queries the dots are f32 sums
of bf16 products in another order than XLA's: values within two key steps
(3.1e-5), ids equal on at least 99% of the (query, window) pairs, and the
top-k after the fold equal. The CUDA kernels are held to their plain twin
by tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops import scan_select as ref
from dawnsearch_tpu_torch.ops import quant
from dawnsearch_tpu_torch.ops import scan_select as ss

torch.set_num_threads(2)

N, D, B, COUNT = 32768, 384, 8, 30000  # two tiles; the mask bites in the second


def _unit(rng, n):
    v = rng.standard_normal((n, D), np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def rows_q():
    rng = np.random.default_rng(0)
    rows = _unit(rng, N)
    # queries near stored rows: small distances, so the kept keys come
    # from close competitors and ties between them matter
    q = rows[rng.integers(0, COUNT, B)] + 0.05 * _unit(rng, B)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return rows, q


@pytest.fixture(scope="module")
def data(rows_q):
    rows, q = rows_q
    scales = (np.maximum(np.abs(rows).max(1), 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales, q


@pytest.fixture(scope="module")
def data_i4(rows_q):
    """Row-block packed i4 codes ((N/2, D) uint8, block 16384) + scales."""
    rows, q = rows_q
    vals, scales = quant.quantize_i4_vals_np(rows)
    return quant.pack_i4_np(vals, quant.I4_BLOCK), scales, q


def test_query_quantization_matches_reference(data):
    _, _, q = data
    qq, qs = ss.quantize_queries(torch.from_numpy(q))
    jq = jnp.asarray(q)
    want_qs = jnp.maximum(jnp.max(jnp.abs(jq), axis=1, keepdims=True),
                          1e-30) / 127.0
    want_qq = jnp.round(jq / want_qs).astype(jnp.int8)
    np.testing.assert_array_equal(qq.numpy(), np.asarray(want_qq))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(want_qs)[:, 0])


def _numpy_contract(qq, qs, codes, scales, count):
    """The reference kernel's math written out in numpy: exact integer
    dots, then (f32(dot)·qs)·scale and 2 - x as separately rounded f32
    ops, the count mask, and the packed-key minimum per strided window."""
    dots = (qq.astype(np.int64) @ codes.astype(np.int64).T).astype(np.float32)
    scaled = (dots * qs[:, None]).astype(np.float32)
    db = (np.float32(2.0) - (scaled * scales[None, :]).astype(np.float32))
    db[:, count:] = np.inf
    keys = (db.view(np.int32) & ~0x7F).reshape(len(qq), -1, ss.W, ss.W)
    keys = keys | np.arange(ss.W, dtype=np.int32)[None, None, :, None]
    best = keys.min(axis=2)
    vals = (best & ~0x7F).view(np.float32) - np.float32(1.0)
    t = np.arange(best.shape[1])[None, :, None] * ss.DEFAULT_TN
    ids = (t + (best & 0x7F) * ss.W + np.arange(ss.W)[None, None, :])
    ids = np.where(np.isfinite(vals), ids, -1).astype(np.int32)
    return vals.reshape(len(qq), -1), ids.reshape(len(qq), -1)


def test_candidates_match_reference(data):
    """Bit-equal to the reference kernel's math as written; against the
    interpret-mode kernel, within one key step: XLA on the CPU contracts
    2 - scaled·scale into an FMA (the reference's values match the FMA
    rounding), which moves the truncated key by one step on ~0.1% of
    candidates (ROADMAP.md Queue 3)."""
    codes, scales, q = data
    qq, qs = ss.quantize_queries(torch.from_numpy(q))
    got_v, got_i = ss.select_candidates_plain(
        qq, qs, torch.from_numpy(codes), torch.from_numpy(scales), COUNT)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_v.shape == (B, N // ss.W)
    exp_v, exp_i = _numpy_contract(qq.numpy(), qs.numpy(), codes, scales, COUNT)
    np.testing.assert_array_equal(got_v.view(np.int32), exp_v.view(np.int32))
    np.testing.assert_array_equal(got_i, exp_i)
    # the masked tail of the second tile came back empty
    assert np.all(got_i[:, 128:][np.isinf(got_v[:, 128:])] == -1)

    want_v, want_i = ref._candidates(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q),
        jnp.int32(COUNT), tb=B, tn=ss.DEFAULT_TN, qi8=True)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    same = got_v.view(np.int32) == want_v.view(np.int32)
    assert same.mean() > 0.99
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    assert np.abs(got_v - want_v)[finite].max() <= 3.1e-5
    np.testing.assert_array_equal(got_i[same], want_i[same])


def test_k3_candidates_match_reference(data_i4):
    """K3 (qi8): bit-equal to the written math over the unpacked codes;
    against the interpret-mode kernel within one key step, as K2."""
    codes, scales, q = data_i4
    qq, qs = ss.quantize_queries(torch.from_numpy(q))
    got_v, got_i = ss.select_candidates_plain(
        qq, qs, torch.from_numpy(codes), torch.from_numpy(scales), COUNT)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_v.shape == (B, N // ss.W)
    exp_v, exp_i = _numpy_contract(qq.numpy(), qs.numpy(),
                                   quant.unpack_i4_np(codes), scales, COUNT)
    np.testing.assert_array_equal(got_v.view(np.int32), exp_v.view(np.int32))
    np.testing.assert_array_equal(got_i, exp_i)
    assert np.all(got_i[:, 128:][np.isinf(got_v[:, 128:])] == -1)

    want_v, want_i = ref._candidates_i4(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q),
        jnp.int32(COUNT), tb=B, tn=ss.DEFAULT_TN, qi8=True)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    same = got_v.view(np.int32) == want_v.view(np.int32)
    assert same.mean() > 0.99
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    assert np.abs(got_v - want_v)[finite].max() <= 3.1e-5
    np.testing.assert_array_equal(got_i[same], want_i[same])


@pytest.mark.parametrize("fmt", ["bf16", "i8", "i4"])
def test_bf16_query_variants_match_reference(rows_q, data, data_i4, fmt):
    """K2 over bf16 codes, K2 i8 with qi8=False and K3 with qi8=False:
    bf16-rounded queries, no query scale, f32 sums in another order."""
    rows, q = rows_q
    if fmt == "bf16":
        codes_t, scales_t = torch.from_numpy(rows).bfloat16(), None
        codes_j, scales_j = jnp.asarray(rows, jnp.bfloat16), None
    else:
        codes, scales, _ = data if fmt == "i8" else data_i4
        codes_t, scales_t = torch.from_numpy(codes), torch.from_numpy(scales)
        codes_j, scales_j = jnp.asarray(codes), jnp.asarray(scales)
    got_v, got_i = ss.select_candidates_plain(
        torch.from_numpy(q).bfloat16(), None, codes_t, scales_t, COUNT)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    cand = ref._candidates_i4 if fmt == "i4" else ref._candidates
    want_v, want_i = cand(codes_j, scales_j, jnp.asarray(q), jnp.int32(COUNT),
                          tb=B, tn=ss.DEFAULT_TN, qi8=False)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    assert np.abs(got_v - want_v)[finite].max() <= 3.1e-5
    assert (got_i == want_i).mean() >= 0.99
    # the default for bf16 codes, an override for i8 and i4
    qi8 = None if fmt == "bf16" else False
    got_d, got_top = ss.search_select(codes_t, scales_t, torch.from_numpy(q),
                                      COUNT, 10, qi8=qi8)
    want_d, want_top = ref.search_select(codes_j, scales_j, jnp.asarray(q),
                                         jnp.int32(COUNT), 10, qi8=qi8)
    np.testing.assert_array_equal(got_top.numpy(), np.asarray(want_top))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=3.1e-5)


def test_search_select_matches_reference(data):
    codes, scales, q = data
    want_d, want_i = ref.search_select(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(q),
        jnp.int32(COUNT), 10)
    got_d, got_i = ss.search_select(torch.from_numpy(codes),
                                    torch.from_numpy(scales),
                                    torch.from_numpy(q), COUNT, 10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_fold_and_topk_match_reference_on_ties(monkeypatch):
    """Wide candidate sets fold by halves (ties keep the left half) and
    the final top-k orders equal values by column, like lax.top_k."""
    rng = np.random.default_rng(1)
    C = 32768  # three folds down to 4096 columns
    vals = np.round(rng.random((B, C)), 2).astype(np.float32)  # many ties
    vals[:, ::7] = np.inf
    ids = rng.integers(0, 1 << 22, (B, C)).astype(np.int32)
    ids[np.isinf(vals)] = -1
    monkeypatch.setattr(ref, "_candidates",
                        lambda *a, **kw: (jnp.asarray(vals), jnp.asarray(ids)))
    want_d, want_i = ref.search_select(
        jnp.zeros((ss.DEFAULT_TN, 128), jnp.int8),
        jnp.ones((ss.DEFAULT_TN,), jnp.float32),
        jnp.asarray(_unit(rng, B)[:, :128]), jnp.int32(1), 10)
    got_d, got_i = ss.fold_topk(torch.from_numpy(vals), torch.from_numpy(ids),
                                10)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_gate_matches_reference():
    for count, cap, dim, dtype in [(262_144, 262_144, 384, "i8"),
                                   (262_143, 262_144, 384, "i8"),
                                   (300_000, 300_000, 384, "i8"),
                                   (300_000, 327_680, 384, "i8"),
                                   (300_000, 327_680, 384, "f32"),
                                   (300_000, 327_680, 96, "i8"),
                                   (300_000, 327_680, 384, "i4"),
                                   (300_000, 327_680, 384, "bf16"),
                                   (262_143, 327_680, 384, "i4"),
                                   (300_000, 300_000, 384, "bf16")]:
        assert ss.eligible(count, cap, dim, dtype) == \
            ref.eligible(count, cap, dim, dtype), (count, cap, dim, dtype)
    # i4 pins the tile to its packing block in both; the port's kernels
    # have one tile size, so it refuses any other for every dtype
    assert not ref.supports(327_680, 384, "i4", tn=32768)
    for dtype in ("i8", "bf16", "i4"):
        assert not ss.supports(327_680, 384, dtype, tn=32768)
    assert ss.MIN_ROWS == ref.MIN_ROWS and ss.DEFAULT_TN == ref.DEFAULT_TN


def test_wrapper_runs_plain_on_cpu_and_guards_capacity(data):
    codes, scales, q = data
    qq, qs = ss.quantize_queries(torch.from_numpy(q))
    before = dict(ss.launches)
    got = ss.select_candidates(qq, qs, torch.from_numpy(codes),
                               torch.from_numpy(scales), COUNT)
    want = ss.select_candidates_plain(qq, qs, torch.from_numpy(codes),
                                      torch.from_numpy(scales), COUNT)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ss.launches == before
    with pytest.raises(ValueError, match="capacity"):
        ss.search_select(torch.from_numpy(codes[:20000]),
                         torch.from_numpy(scales[:20000]),
                         torch.from_numpy(q), COUNT, 10)
    with pytest.raises(NotImplementedError):
        ss.search_select(torch.from_numpy(codes).float(), None,
                         torch.from_numpy(q), COUNT, 10)



def test_search_select_guards_the_i4_tile_and_the_query_type(data_i4, rows_q):
    codes, scales, q = data_i4
    rows, _ = rows_q
    with pytest.raises(ValueError, match="16384"):
        ss.search_select(torch.from_numpy(codes), torch.from_numpy(scales),
                         torch.from_numpy(q), COUNT, 10, tn=8192)
    with pytest.raises(ValueError, match="qi8=False"):
        ss.search_select(torch.from_numpy(rows).bfloat16(), None,
                         torch.from_numpy(q), COUNT, 10, qi8=True)


@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 64, 100, 1024])
@pytest.mark.parametrize("N,count", [(16384, 16384), (524288, 270000),
                                     (1 << 20, (1 << 20) - 1000),
                                     (1 << 26, 1 << 26), (1 << 26, 100000),
                                     (524288, 0)])
@pytest.mark.parametrize("sms", [132, 8])
def test_select_plan_covers_every_block_once(B, N, count, sms):
    """The CUDA kernel's launch plan: the query tile holds B (or is 64),
    s is a power of two that divides a tile's 128 window blocks and its 64
    packed i4 blocks, and the s CTAs' shares cover every block of a tile
    exactly once. s grows only while the live tiles leave the card short
    of two CTAs an SM, and never past the grid's limit (an i4 index at its
    64M-row capacity with few live tiles, as after a load)."""
    qb, s = ss.plan_select(B, N, count, sms)
    assert qb in ss.QUERY_TILES and (B <= qb or qb == 64)
    assert s & (s - 1) == 0 and 1 <= s <= ss.MAX_SPLIT
    tiles = N // ss.DEFAULT_TN
    assert tiles * s <= ss.MAX_GRID_Y
    for blocks in (ss.W, ss.W // 2):
        assert blocks % s == 0
        seen = [b for q in range(s) for b in ss.split_blocks(s, q, blocks)]
        assert sorted(seen) == list(range(blocks))
    live = -(-count // ss.DEFAULT_TN)
    work = -(-B // qb) * live
    if s > 1:
        assert work * (s // 2) < 2 * sms
    assert (work * s >= 2 * sms or s == ss.MAX_SPLIT or live == 0
            or tiles * s * 2 > ss.MAX_GRID_Y)


def test_select_plan_spreads_a_node_query_over_the_card():
    """A B = 1 query over the node's index (capacity 524,288, 270,000
    rows: 17 live tiles) runs 8-query tiles split 16 ways: 272 CTAs hold
    live rows, two an SM on 132 SMs."""
    assert ss.plan_select(1, 524288, 270_000, 132) == (8, 16)
    assert ss.plan_select(8, 524288, 270_000, 132) == (8, 16)
    assert ss.plan_select(1024, 1 << 20, (1 << 20) - 1000, 132) == (64, 1)
    # a searcher's batch of 32 takes the 64-query tile
    assert ss.plan_select(32, 524288, 270_000, 132) == (64, 16)


def _split_select(keys, count, s, blocks_per_tile, nb):
    """The kernel's fold written out over full (B, T, 128 w, 128 r) keys:
    CTA q of each tile folds only its live staged blocks (a block is live
    while its first row is below count), folds its skipped blocks in as
    the key (+inf | first skipped w), and the s CTAs' minima combine; a
    tile with no live row stores (+inf, w = 0)."""
    Bq, T = keys.shape[:2]
    out = np.empty((Bq, T, ss.W), np.int32)
    for t in range(T):
        left = count - t * ss.DEFAULT_TN
        live_blocks = 0 if left <= 0 else min(blocks_per_tile,
                                              -(-left // ss.W))
        if live_blocks == 0:
            out[:, t] = 0x7F800000
            continue
        best = np.full((Bq, ss.W), np.iinfo(np.int32).max, np.int32)
        for q in range(s):
            blk = ss.split_blocks(s, q, blocks_per_tile)
            live1 = min(blk.stop, max(blk.start, live_blocks))
            part = np.full((Bq, ss.W), np.iinfo(np.int32).max, np.int32)
            if live1 < blk.stop:
                part[:] = 0x7F800000 | live1
            for b in range(blk.start, live1):
                for h in range(nb):
                    part = np.minimum(part, keys[:, t, b + 64 * h])
            best = np.minimum(best, part)
        out[:, t] = best
    return out


@pytest.mark.parametrize("fmt", ["i8", "i4"])
@pytest.mark.parametrize("count", [30000, 16384, 16383, 100, 1, 0])
@pytest.mark.parametrize("s", [1, 2, 16])
def test_split_and_skipped_blocks_fold_to_the_plain_result(data, data_i4,
                                                           fmt, count, s):
    """Splitting a tile's blocks over s CTAs, skipping blocks and tiles
    wholly past count and folding the skipped ones in as (+inf | first
    skipped w) gives select_candidates_plain's packed keys bit for bit,
    for i8 (128 blocks a tile) and packed i4 (64 packed blocks, each the
    windows w and w + 64)."""
    codes, scales, q = data if fmt == "i8" else data_i4
    ct, st = torch.from_numpy(codes), torch.from_numpy(scales)
    qq, qs = ss.quantize_queries(torch.from_numpy(q))
    want_v, want_i = ss.select_candidates_plain(qq, qs, ct, st, count)
    x = quant.unpack_i4(ct, quant.I4_BLOCK) if fmt == "i4" else ct
    db = 2.0 - (qq.float() @ x.float().T) * qs.reshape(-1, 1) \
        * st.reshape(1, -1)
    rows = torch.arange(N)
    db = torch.where(rows < count, db, torch.inf)
    keys = ((db.view(torch.int32) & ~0x7F).reshape(B, -1, ss.W, ss.W)
            | torch.arange(ss.W, dtype=torch.int32).reshape(1, 1, ss.W, 1))
    blocks, nb = (ss.W, 1) if fmt == "i8" else (ss.W // 2, 2)
    best = _split_select(keys.numpy(), count, s, blocks, nb)
    want_best = (want_v.reshape(B, -1, ss.W) + 1.0).view(torch.int32)
    np.testing.assert_array_equal(best & ~0x7F, want_best.numpy())
    T = N // ss.DEFAULT_TN
    ids = (np.arange(T)[None, :, None] * ss.DEFAULT_TN + (best & 0x7F) * ss.W
           + np.arange(ss.W)[None, None, :])
    vals = (best & ~0x7F).view(np.float32) - np.float32(1.0)
    ids = np.where(np.isfinite(vals), ids, -1)
    np.testing.assert_array_equal(ids.reshape(B, -1), want_i.numpy())


@pytest.mark.parametrize("count", [16384, 100, 0])
@pytest.mark.parametrize("fmt,qi8", [("i8", True), ("i8", False),
                                     ("i4", True), ("bf16", False)])
def test_tiles_past_count_are_the_empty_result(rows_q, data, data_i4, count,
                                               fmt, qi8):
    """A tile wholly past count gives (+inf, -1) in every column of the
    plain twin, in every variant: what the kernel stores there without
    reading its codes."""
    rows, q = rows_q
    if fmt == "i8":
        codes, scales = (torch.from_numpy(a) for a in data[:2])
    elif fmt == "i4":
        codes, scales = (torch.from_numpy(a) for a in data_i4[:2])
    else:
        codes, scales = torch.from_numpy(rows).bfloat16(), None
    qt = torch.from_numpy(q)
    qq, qs = ss.quantize_queries(qt) if qi8 else (qt.bfloat16(), None)
    vals, ids = ss.select_candidates_plain(qq, qs, codes, scales, count)
    first_dead = -(-count // ss.DEFAULT_TN)
    assert first_dead < N // ss.DEFAULT_TN
    dead = slice(first_dead * ss.W, None)
    assert bool(torch.isinf(vals[:, dead]).all())
    assert bool((vals[:, dead] > 0).all())
    assert bool((ids[:, dead] == -1).all())
