"""K5, K6 and K8: the port's plain twins vs the reference kernels.

The reference's fused_attention_packed (K5), fused_attention (K6) and
fused_mean_pool (K8) run their Pallas kernels in interpret mode on the
CPU (as tests/test_pallas_kernels.py runs them); the port's
attention_packed_plain, attention_plain and mean_pool_plain get the same
seeded numpy inputs. Tolerances are the reference's own: attention f32
atol 2e-5 (test_pallas_kernels.py:40) and bf16 per-row cosine > 0.999;
the pool atol 1e-5 and unit norm within 1e-5 (test_pallas_kernels.py:61-62).
The CUDA kernels are held against the plain twins on a card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops import attention as ref
from dawnsearch_tpu_torch.ops import attention

torch.set_num_threads(2)

B, S = 4, 32
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _mask(rng, b=B, s=S):
    lengths = rng.integers(3, s + 1, b)
    lengths[0] = s
    mask = np.arange(s)[None, :] < lengths[:, None]
    return mask, np.where(mask, 0.0, -1e30).astype(np.float32)


def _agree(got: np.ndarray, want: np.ndarray, dtype: str, hd: int) -> None:
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5)
    else:
        g, w = got.reshape(-1, hd), want.reshape(-1, hd)
        cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                                 * np.linalg.norm(w, axis=-1))
        assert cos.min() > 0.999, cos.min()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_packed_plain_matches_reference_kernel(dtype, with_bias):
    """K5 at H=128, nh=4 (hd 32). The port reads q, k and v as column
    slices of one (B, S, 3H) projection output, as the encoder does."""
    H, nh = 128, 4
    rng = np.random.default_rng(0)
    qkv = rng.standard_normal((B, S, 3 * H), np.float32)
    _, bias = _mask(rng)
    jdt, tdt = DTYPES[dtype]
    q, k, v = np.split(qkv, 3, axis=-1)
    want = np.asarray(ref.fused_attention_packed(
        *(jnp.asarray(t, jdt) for t in (q, k, v)),
        jnp.asarray(bias) if with_bias else None, nh=nh)).astype(np.float32)
    tq, tk, tv = torch.from_numpy(qkv).to(tdt).split(H, dim=-1)
    got = attention.attention_packed_plain(
        tq, tk, tv, torch.from_numpy(bias) if with_bias else None, nh)
    assert got.dtype == tdt
    _agree(got.float().numpy(), want, dtype, H // nh)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nh,hd", [(4, 16), (3, 26)])
def test_head_major_plain_matches_reference_kernel(dtype, nh, hd):
    """K6 at hd 16 and at hd 26 (TinyBERT's head dim, outside the packed
    envelope)."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((B, nh, S, hd), np.float32)
               for _ in range(3))
    _, bias = _mask(rng)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(ref.fused_attention(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(bias),
        nh=nh)).astype(np.float32)
    got = attention.attention_plain(
        *(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
        torch.from_numpy(bias), nh)
    assert got.dtype == tdt
    _agree(got.float().numpy(), want, dtype, hd)


@pytest.mark.parametrize("include_padding", [False, True])
def test_mean_pool_plain_matches_reference_kernel(include_padding):
    rng = np.random.default_rng(3)
    mask, _ = _mask(rng)
    mask = mask.astype(np.int32)
    mask[2] = 0                        # an all-padding row: count clamps at 1
    hidden = rng.standard_normal((B, S, 384), np.float32)
    want = np.asarray(ref.fused_mean_pool(jnp.asarray(hidden),
                                          jnp.asarray(mask),
                                          include_padding=include_padding))
    got = attention.mean_pool_plain(torch.from_numpy(hidden),
                                    torch.from_numpy(mask),
                                    include_padding).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    norms = np.linalg.norm(got, axis=-1)
    np.testing.assert_allclose(norms[norms > 0], 1.0, atol=1e-5)


def test_wrappers_run_the_plain_twins_on_cpu_without_launching():
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 16, 384), np.float32))
    q, k, v = qkv.bfloat16().split(128, dim=-1)
    heads = [t.reshape(2, 16, 4, 32).transpose(1, 2).contiguous()
             for t in (q, k, v)]
    _, bias = _mask(rng, 2, 16)
    bias = torch.from_numpy(bias)
    hidden = torch.from_numpy(rng.standard_normal((2, 16, 128), np.float32))
    mask = (bias == 0).int()
    before = dict(attention.launches)
    assert torch.equal(attention.fused_attention_packed(q, k, v, bias, 4),
                       attention.attention_packed_plain(q, k, v, bias, 4))
    assert torch.equal(attention.fused_attention(*heads, bias, 4),
                       attention.attention_plain(*heads, bias, 4))
    assert torch.equal(attention.fused_mean_pool(hidden, mask),
                       attention.mean_pool_plain(hidden, mask))
    assert attention.launches == before


def test_packed_and_head_major_twins_agree():
    """The two layouts compute one function: K5 on (B, S, H) equals K6 on
    the same heads transposed to (B, nh, S, hd), bit for bit."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, 128), np.float32))
               .bfloat16() for _ in range(3))
    _, bias = _mask(rng)
    bias = torch.from_numpy(bias)
    packed = attention.attention_packed_plain(q, k, v, bias, 4)
    heads = [t.reshape(B, S, 4, 32).transpose(1, 2) for t in (q, k, v)]
    head_major = attention.attention_plain(*heads, bias, 4)
    assert torch.equal(packed, head_major.transpose(1, 2).reshape(B, S, 128))
