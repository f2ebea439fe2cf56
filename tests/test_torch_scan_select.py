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
