"""K7: the port's fused-FFN plain twin vs the reference kernel.

The reference's fused_ffn runs its Pallas kernel in interpret mode on the
CPU; the port's ffn_plain gets the same seeded numpy inputs, at MiniLM
width (384/1536) and at TinyBERT width (312/1200, a depth that is not a
multiple of 16). Tolerances: f32 atol 1e-4 (the reference's encoder
parity bound), bf16 per-row cosine > 0.999. The CUDA kernel is held
against ffn_plain on a card by tests/test_torch_kernels_gpu.py and
chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops.ffn import fused_ffn as ref_ffn
from dawnsearch_tpu_torch.ops import ffn

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
