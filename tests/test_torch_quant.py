"""The port's i4 codec (ops/quant.py) vs the JAX package's.

The same seeded rows go through both packages: quantization (with values
that sit exactly halfway between two codes, where both round half to
even), row-block packing and unpacking, the in-place read-modify-write
of `write_rows_i4` against the reference's functional one, and the
fetch-width ladder at every rung boundary. Everything must be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops import quant as ref
from dawnsearch_tpu_torch.ops import quant

torch.set_num_threads(2)

D = 384


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    # absmax 7 gives scale 1, so these land exactly halfway between codes
    x[0, :8] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 6.5]
    x[1] = 0.0  # an all-zero row: scale floors at 1e-12 / 7
    return x


def test_quantize_matches_reference(rows):
    vals, scales = quant.quantize_i4_vals_np(rows)
    want_v, want_s = ref.quantize_i4_vals_np(rows)
    np.testing.assert_array_equal(vals, want_v)
    np.testing.assert_array_equal(scales, want_s)
    assert vals[0, :8].tolist() == [15, 8, 10, 10, 8, 6, 6, 14]
    # the device twin divides like the host one, so host and device adds
    # store the same bytes
    tv, ts = quant.quantize_i4_vals(torch.from_numpy(rows))
    assert tv.dtype == torch.uint8
    np.testing.assert_array_equal(tv.numpy(), want_v)
    np.testing.assert_array_equal(ts.numpy(), want_s)
    # the reference's jitted twin: XLA turns x / 7 into x * f32(1/7), so
    # its scales are within one ulp of the quotient (ROADMAP.md Queue 3);
    # the codes agree
    jv, js = ref.quantize_i4_vals(jnp.asarray(rows))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    assert (ts.numpy() != np.asarray(js)).any()
    with pytest.raises(ValueError, match="even dim"):
        quant.quantize_i4_vals_np(rows[:, :7])


@pytest.mark.parametrize("block", [64, 256])
def test_pack_and_unpack_match_reference(rows, block):
    vals, _ = ref.quantize_i4_vals_np(rows)
    packed = quant.pack_i4_np(vals, block)
    np.testing.assert_array_equal(packed, ref.pack_i4_np(vals, block))
    want = ref.unpack_i4_np(packed, block)
    np.testing.assert_array_equal(quant.unpack_i4_np(packed, block), want)
    got = quant.unpack_i4(torch.from_numpy(packed), block)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(ref.unpack_i4(jnp.asarray(packed), block)), want)


@pytest.mark.parametrize("start,n", [
    (10, 5),      # inside one block
    (60, 10),     # straddles the edge between blocks 0 and 1
    (64, 64),     # exactly one aligned block
    (130, 126),   # runs to the end of the buffer
    (0, 256)])    # the whole buffer
def test_write_rows_i4_matches_reference(rows, start, n):
    block, cap = 64, 256
    rng = np.random.default_rng(start)
    prior = rng.integers(0, 256, (cap // 2, D), dtype=np.uint8)
    vals, _ = ref.quantize_i4_vals_np(rows[:n])
    buf = torch.from_numpy(prior.copy())
    quant.write_rows_i4(buf, torch.from_numpy(vals), start, block)
    want = ref.write_rows_i4(jnp.asarray(prior), jnp.asarray(vals), start,
                             block)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
    # the written rows read back; every other row kept its nibbles
    logical = quant.unpack_i4_np(buf.numpy(), block)
    before = quant.unpack_i4_np(prior, block)
    np.testing.assert_array_equal(logical[start:start + n],
                                  vals.astype(np.int8) - 8)
    keep = np.ones(cap, bool)
    keep[start:start + n] = False
    np.testing.assert_array_equal(logical[keep], before[keep])


def test_write_rows_i4_refuses_rows_past_the_buffer(rows):
    buf = torch.zeros((128, D), dtype=torch.uint8)
    vals, _ = quant.quantize_i4_vals(torch.from_numpy(rows[:10]))
    with pytest.raises(ValueError, match="outside"):
        quant.write_rows_i4(buf, vals, 250, 64)


@pytest.mark.parametrize("count", [500_000, 500_001, 2_000_000, 2_000_001,
                                   8_000_000, 8_000_001])
def test_fetch_width_ladder_matches_reference(count):
    for k in (10, 100, 300, 600):
        assert quant.i4_fetch_width(count, k) == ref.i4_fetch_width(count, k)


def test_block_choice_matches_reference():
    assert quant.I4_BLOCK == ref.I4_BLOCK
    for segment in (16384, 32768, 4096, 64):
        assert quant.i4_block_for(segment) == ref.i4_block_for(segment)
    for mod in (quant, ref):
        with pytest.raises(ValueError, match="even segment"):
            mod.i4_block_for(4095)
