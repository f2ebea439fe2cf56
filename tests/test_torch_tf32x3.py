"""3xTF32: the bound checked on the CPU before the card runs it.

K1's f32 GEMM and the f32 attention (K1's step, K5, K6) multiply on the
tensor cores in TF32 and split every f32 operand x = hi + lo, hi =
tf32(x), lo = tf32(x - hi), both rounded to nearest with ties away from
zero (`cvt.rna.tf32.f32`); a product is hi·hi + hi·lo + lo·hi in f32.
Here, with seeded numpy inputs:

- the port's split (ops/layer.py::split_tf32) rounds as cvt.rna does: hi
  and lo keep 10 explicit mantissa bits, hi is the nearest TF32 value
  (ties away from zero), and |x - hi - lo| <= 2^-21·|x| for normal x whose
  residual is normal (|x| >= 2^-102); below that, subnormals included,
  the split is exact to half a TF32 step of the smallest exponent
  (2^-137); 0 splits into zeros;
- the 3xTF32 product emulated on the CPU holds the f32 bound against the
  f64 product where one TF32 product does not;
- K1's f32 layer with every product 3xTF32 and its attention in one pass
  with a running max over 64-key tiles (the kernels' arithmetic, f32
  sums in another order) agrees with the reference's f32 layer
  (dawnsearch_tpu.ops.layer.fused_bert_layer, its Pallas kernel in
  interpret mode, as tests/test_torch_layer.py runs it) at the
  reference's f32 atol 1e-4, over 2 layers at MiniLM width with ragged
  masks, with and without MPNet's rel_bias;
- that attention agrees with attention_f32_plain, the contract's twin,
  within 1e-5 of the output's scale, with whole key tiles masked and a
  sequence with every key masked.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops.layer import fused_bert_layer as ref_layer
from dawnsearch_tpu_torch.ops import layer
from dawnsearch_tpu_torch.ops.ffn import erf_poly
from dawnsearch_tpu_torch.ops.vector import layer_norm

torch.set_num_threads(2)

H, I, NH = 384, 1536, 12
KT = 64  # the kernels' key tile


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _specials() -> np.ndarray:
    """0, ±0, subnormals, the smallest normals and large values short of
    the last half TF32 step below f32's largest."""
    tiny = np.float32(2.0 ** -126)
    return np.array([0.0, -0.0, 1e-45, -1e-45, 3e-42, -7.7e-41, 1.1e-38,
                     tiny, -tiny, 2.0 ** -102, 1e30, -1e30, 3.0e38,
                     -3.3e38, 1.0, -1.0], dtype=np.float32)


def _normals(rng) -> np.ndarray:
    mant = rng.uniform(1.0, 2.0, 4000)
    exps = rng.integers(-101, 127, 4000)
    sign = rng.choice([-1.0, 1.0], 4000)
    return (sign * mant * np.exp2(exps.astype(np.float64))).astype(np.float32)


def _nearest_tf32(x: np.ndarray) -> np.ndarray:
    """The TF32 value nearest each normal f32 x, ties away from zero,
    computed in f64 from the exponent (independent of the bit trick)."""
    x64 = x.astype(np.float64)
    step = np.exp2(np.floor(np.log2(np.abs(x64))) - 10)
    q = np.abs(x64) / step
    r = np.floor(q + 0.5)          # q >= 0: ties go up, away from zero
    return (np.sign(x64) * r * step).astype(np.float32)


def test_split_tf32_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    x = np.concatenate([_normals(rng), _specials()])
    hi, lo = layer.split_tf32(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.float32
    assert (_bits(hi) & 0x1FFF == 0).all()
    assert (_bits(lo) & 0x1FFF == 0).all()
    assert np.isfinite(hi.numpy()).all() and np.isfinite(lo.numpy()).all()
    x64 = x.astype(np.float64)
    resid = np.abs(x64 - hi.numpy().astype(np.float64)
                   - lo.numpy().astype(np.float64))
    normal = np.abs(x64) >= 2.0 ** -102
    assert (resid[normal] <= 2.0 ** -21 * np.abs(x64[normal])).all()
    assert (resid[~normal] <= 2.0 ** -137).all()
    zero = x == 0
    assert (hi.numpy()[zero] == 0).all() and (lo.numpy()[zero] == 0).all()
    big = np.abs(x64) >= 2.0 ** -126
    np.testing.assert_array_equal(hi.numpy()[big], _nearest_tf32(x[big]))


def test_split_tf32_ties_go_away_from_zero():
    """1 + 2^-11 is halfway between the TF32 values 1 and 1 + 2^-10."""
    half = np.float32(1.0 + 2.0 ** -11)
    below = np.nextafter(half, np.float32(0.0))
    x = torch.tensor([half, -half, below, -below], dtype=torch.float32)
    hi, lo = layer.split_tf32(x)
    up = 1.0 + 2.0 ** -10
    assert hi.tolist() == [up, -up, 1.0, -1.0]
    # a tie's residual is one TF32 value, so its split is exact
    assert (hi + lo)[:2].tolist() == x[:2].tolist()


def test_tf32_pair_is_the_k_major_split():
    """tf32_pair: the (N, K) halves of a (K, N) matrix, contiguous, whose
    sum is wᵀ within the split's bound."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (96, 40), np.float32))
    hi, lo = layer.tf32_pair(w)
    assert hi.shape == lo.shape == (40, 96)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert torch.equal(hi, layer.split_tf32(w.t())[0])
    d = (w.t().double() - hi.double() - lo.double()).abs()
    assert bool((d <= 2.0 ** -21 * w.t().double().abs()).all())


def _mm3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) f32 @ (K, N) f32 as the card's 3xTF32: hi·hi + hi·lo +
    lo·hi, each product of TF32 operands exact in f32, summed in f32."""
    ah, al = layer.split_tf32(a)
    wh, wl = layer.split_tf32(w)
    return (al @ wh + ah @ wl) + ah @ wh


def test_tf32x3_holds_the_f32_bound_where_tf32_does_not():
    """At K1's widest product (K = 3072), against the f64 product: 3xTF32
    within 1e-5 of the output's scale, one TF32 product (hi·hi) not."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 3072), np.float32))
    w = torch.from_numpy(rng.standard_normal((3072, 384), np.float32) * 0.05)
    want = a.double() @ w.double()
    scale = float(want.abs().max())
    err3 = float((_mm3(a, w).double() - want).abs().max())
    one = layer.split_tf32(a)[0] @ layer.split_tf32(w)[0]
    err1 = float((one.double() - want).abs().max())
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-4 * scale


def _attention_tf32x3(qkv, bias, B, S, H_, nh, rel=None, tile=KT):
    """(M, 3H) f32 qkv -> (M, H) f32 context as the f32 kernel computes
    it: 3xTF32 products, one pass over `tile`-key tiles with a running max
    (the context and l rescaled by exp(m - m') at each tile), s =
    ((dot·scale) + bias) + rel, p unrounded."""
    hd = H_ // nh
    q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(H_, dim=-1))
    m = torch.full((B, nh, S, 1), -math.inf)
    l = torch.zeros((B, nh, S, 1))
    o = torch.zeros((B, nh, S, hd))
    for k0 in range(0, S, tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        s = _mm3(q, kt.transpose(-1, -2))
        s = s * (1.0 / math.sqrt(hd)) + bias[:, None, None, k0:k0 + tile]
        if rel is not None:
            s = s + rel[None, :, :, k0:k0 + tile]
        mn = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + _mm3(p, vt)
        m = mn
    o = o * (1.0 / l)
    return o.transpose(1, 2).reshape(B * S, H_)


def _layer_tf32x3(x, bias, w, nh, eps, rel=None, tile=KT):
    """bert_layer_plain at f32 with every product 3xTF32 and the one-pass
    attention: K1's f32 arithmetic on the card, emulated."""
    qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1, w2, b2, fln_s, fln_b = w
    B, S, H_ = x.shape
    x2d = x.reshape(B * S, H_)
    qkv = _mm3(x2d, qkv_w) + qkv_b
    ctx = _attention_tf32x3(qkv, bias, B, S, H_, nh, rel, tile)
    x1 = layer_norm(_mm3(ctx, ao_w) + ao_b + x2d, aln_s, aln_b, eps)
    h = _mm3(x1, w1) + b1
    h = 0.5 * h * (1.0 + erf_poly(h * 2.0 ** -0.5))
    y = _mm3(h, w2) + b2 + x1
    return layer_norm(y, fln_s, fln_b, eps).reshape(B, S, H_)


def _weights(rng):
    def mat(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def vec(n, base=0.0):
        return (base + rng.standard_normal(n, np.float32) * 0.1
                ).astype(np.float32)
    return [mat(H, 3 * H), vec(3 * H), mat(H, H), vec(H), vec(H, 1.0),
            vec(H), mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]


def _key_bias(lengths, S):
    mask = np.arange(S)[None, :] < np.asarray(lengths)[:, None]
    return mask, np.where(mask, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("rel", [False, True])
def test_k1_f32_with_tf32x3_matches_reference(rel):
    """Two layers at MiniLM width, ragged masks (B=3, S=64, 16-key tiles
    so the running max moves), eps 1e-5 with rel_bias (MPNet's) and
    1e-12 without: the emulated card layer against the reference's f32
    layer at atol 1e-4."""
    B, S, eps = 3, 64, (1e-5 if rel else 1e-12)
    rng = np.random.default_rng(5 + rel)
    x = rng.standard_normal((B, S, H), np.float32)
    _, bias = _key_bias([64, 20, 41], S)
    layers = [_weights(rng), _weights(rng)]
    rb = (rng.standard_normal((NH, S, S), np.float32) * 0.5) if rel else None
    want = jnp.asarray(x)
    got = torch.from_numpy(x)
    for w in layers:
        want = ref_layer(want, jnp.asarray(bias), *[jnp.asarray(a) for a in w],
                         nh=NH, eps=eps,
                         **({"rel_bias": jnp.asarray(rb)} if rel else {}))
        got = _layer_tf32x3(got, torch.from_numpy(bias),
                            [torch.from_numpy(a) for a in w], NH, eps,
                            None if rb is None else torch.from_numpy(rb),
                            tile=16)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape == (B, S, H)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("rel", [False, True])
def test_one_pass_attention_matches_the_contract(rel):
    """The emulated f32 kernel (64-key tiles) against attention_f32_plain
    at S = 192: sequences of 192, 5 (two whole tiles masked after the
    first), 0 (every key masked: a uniform softmax in both) and 130 keys;
    max |d| within 1e-5 of the scale."""
    B, S = 4, 192
    rng = np.random.default_rng(9 + rel)
    qkv = torch.from_numpy(rng.standard_normal((B * S, 3 * H), np.float32))
    _, bias = _key_bias([192, 5, 0, 130], S)
    bias = torch.from_numpy(bias)
    rb = (torch.from_numpy(rng.standard_normal((NH, S, S), np.float32) * 0.5)
          if rel else None)
    got = _attention_tf32x3(qkv, bias, B, S, H, NH, rb)
    want = layer.attention_f32_plain(qkv, bias, B, S, H, NH, rb)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
