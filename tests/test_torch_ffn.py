"""K7: the port's fused-FFN plain twin vs the reference kernel.

The reference's fused_ffn runs its Pallas kernel in interpret mode on the
CPU; the port's ffn_plain gets the same seeded numpy inputs, at MiniLM
width (384/1536) and at TinyBERT width (312/1200, a depth that is not a
multiple of 16). Tolerances: f32 atol 1e-4 (the reference's encoder
parity bound), bf16 per-row cosine > 0.999. The CUDA kernel is held
against ffn_plain on a card by tests/test_torch_kernels_gpu.py and
chip_smoke.py.

K7's f32 instance on the card multiplies 3xTF32 (each f32 operand split
into TF32 hi + lo, products hi·hi + hi·lo + lo·hi in f32) and takes its
LayerNorm over a cluster of 128-column chunks; that arithmetic, emulated
here with ops/layer.py::split_tf32 and ops/vector.py::
layer_norm_from_partials, is held against the reference's f32 kernel at
the same atol 1e-4. K7 takes its f32 matrices only as tf32_pair pairs:
the shared check (ops/_cuda.py::check_matrix) refuses anything else.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops.ffn import fused_ffn as ref_ffn
from dawnsearch_tpu_torch.ops import _cuda, ffn, layer
from dawnsearch_tpu_torch.ops.vector import layer_norm_from_partials

torch.set_num_threads(2)

M = 64


def _inputs(rng, H, I):
    """x and one FFN's weights with non-trivial biases and LayerNorm
    parameters (a dropped bias would show)."""
    def mat(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def vec(n, base=0.0):
        return (base + rng.standard_normal(n, np.float32) * 0.1).astype(np.float32)

    x = rng.standard_normal((M, H), np.float32)
    return x, [mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,I", [(384, 1536), (312, 1200)])
def test_plain_ffn_matches_reference_kernel(dtype, H, I):
    x, weights = _inputs(np.random.default_rng(H), H, I)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    w1, b1, w2, b2, g, be = weights
    want = np.asarray(ref_ffn(jnp.asarray(x, jdt), jnp.asarray(w1, jdt),
                              jnp.asarray(b1), jnp.asarray(w2, jdt),
                              jnp.asarray(b2), jnp.asarray(g),
                              jnp.asarray(be))).astype(np.float32)
    got = ffn.ffn_plain(torch.from_numpy(x).to(tdt),
                        torch.from_numpy(w1).to(tdt), torch.from_numpy(b1),
                        torch.from_numpy(w2).to(tdt),
                        *[torch.from_numpy(a) for a in (b2, g, be)])
    assert got.dtype == tdt and got.shape == (M, H)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.999, cos.min()


def test_erf_polynomial_is_within_its_bound():
    """A&S 7.1.26 (|err| <= 1.5e-7) against the exact erf, zero at zero
    and odd, as the reference kernel's polynomial."""
    x = torch.linspace(-6.0, 6.0, 20001, dtype=torch.float64)
    got = ffn.erf_poly(x)
    assert float((got - torch.erf(x)).abs().max()) <= 1.5e-7
    assert float(ffn.erf_poly(torch.zeros(1))) == 0.0
    assert torch.equal(ffn.erf_poly(-x), -got)
    assert math.isclose(float(ffn.erf_poly(torch.tensor([1.0]))),
                        math.erf(1.0), abs_tol=1.5e-7)


def test_wrapper_runs_plain_on_cpu_without_launching():
    x, weights = _inputs(np.random.default_rng(1), 128, 256)
    args = [torch.from_numpy(x).bfloat16(),
            *[torch.from_numpy(w).bfloat16() if w.ndim == 2
              else torch.from_numpy(w) for w in weights]]
    before = dict(ffn.launches)
    assert torch.equal(ffn.fused_ffn(*args), ffn.ffn_plain(*args))
    assert ffn.launches == before


def _mm3(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) f32 @ (K, N) f32 as the card's 3xTF32: hi·hi + hi·lo +
    lo·hi, each product of TF32 operands exact in f32, summed in f32."""
    ah, al = layer.split_tf32(a)
    wh, wl = layer.split_tf32(w)
    return (al @ wh + ah @ wl) + ah @ wh


@pytest.mark.parametrize("H,I", [(384, 1536), (312, 1200)])
def test_tf32x3_ffn_matches_reference_kernel(H, I):
    """K7 f32's arithmetic (3xTF32 products, the cluster's 128-column
    LayerNorm order, ragged at 312) against the reference's f32 kernel in
    interpret mode: atol 1e-4."""
    x, weights = _inputs(np.random.default_rng(H + 1), H, I)
    w1, b1, w2, b2, g, be = weights
    want = np.asarray(ref_ffn(*[jnp.asarray(a) for a in (x, *weights)]))
    t = [torch.from_numpy(a) for a in (x, *weights)]
    h = _mm3(t[0], t[1]) + t[2]
    h = 0.5 * h * (1.0 + ffn.erf_poly(h * 2.0 ** -0.5))
    y = (_mm3(h, t[3]) + t[4]) + t[0]
    got = layer_norm_from_partials(y, t[5], t[6], 1e-12)
    assert got.shape == (M, H) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_matrix_check_takes_the_tf32_pair_at_f32():
    """The check K1 and K7 share: at f32 the (W_hi, W_lo) pair, each
    (out, in); a plain f32 matrix, a pair in the (in, out) shape or a lone
    tensor in a tuple is refused by name; at bf16 the (in, out) matrix."""
    cpu, f32 = torch.device("cpu"), torch.float32
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 96), np.float32))
    _cuda.check_matrix("K7", "w1", layer.tf32_pair(w), 64, 96, f32, cpu)
    _cuda.check_matrix("K7", "w1", w.bfloat16(), 64, 96, torch.bfloat16, cpu)
    with pytest.raises(ValueError, match=r"K7 w1: at f32 .*\(W_hi, W_lo\) "
                                         r"pair.*got torch.float32 \(64, 96\)"):
        _cuda.check_matrix("K7", "w1", w, 64, 96, f32, cpu)
    with pytest.raises(ValueError, match="K7 w2 hi"):
        _cuda.check_matrix("K7", "w2", (w, w), 64, 96, f32, cpu)
    with pytest.raises(ValueError, match="got tuple"):
        _cuda.check_matrix("K7", "w1", (w,), 64, 96, f32, cpu)
    with pytest.raises(ValueError, match="K1 w2: want contiguous"):
        _cuda.check_matrix("K1", "w2", w, 64, 96, torch.bfloat16, cpu)
