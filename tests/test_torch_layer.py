"""K1: the port's whole-layer plain twin vs the reference kernel.

The reference's fused_bert_layer runs its Pallas kernel in interpret mode
on the CPU (as tests/test_pallas_kernels.py runs it); the port's
bert_layer_plain gets the same seeded numpy inputs. Tolerances are the
reference's own (test_pallas_kernels.py:105,142): f32 atol 1e-4, bf16
per-row cosine > 0.999 after masked mean pooling. The CUDA kernel itself
is compared with bert_layer_plain on a card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dawnsearch_tpu.ops.layer import fused_bert_layer as ref_layer
from dawnsearch_tpu_torch.ops import layer

torch.set_num_threads(2)

H, I, NH, B, S = 384, 1536, 12, 4, 32


def _inputs(seed: int = 0):
    """x, mask, f32 key bias and one layer's weights with non-trivial
    biases and LayerNorm parameters (a dropped bias would show)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H), np.float32)
    mask = np.ones((B, S), bool)
    mask[1, 10:] = False
    mask[3, 5:] = False
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)

    def mat(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def vec(n, base=0.0):
        return (base + rng.standard_normal(n, np.float32) * 0.1).astype(np.float32)

    weights = [mat(H, 3 * H), vec(3 * H), mat(H, H), vec(H), vec(H, 1.0),
               vec(H), mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]
    return x, mask, bias, weights


def _pool(y: np.ndarray, mask: np.ndarray) -> np.ndarray:
    m = mask[..., None].astype(np.float32)
    p = (y * m).sum(1) / m.sum(1)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_layer_matches_reference_kernel(dtype):
    x, mask, bias, weights = _inputs()
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(ref_layer(
        jnp.asarray(x, jdt), jnp.asarray(bias),
        *[jnp.asarray(w) for w in weights], nh=NH)).astype(np.float32)
    got = layer.bert_layer_plain(
        torch.from_numpy(x).to(tdt), torch.from_numpy(bias),
        *[torch.from_numpy(w) for w in weights], nh=NH).float().numpy()
    assert got.shape == want.shape == (B, S, H)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        cos = np.sum(_pool(got, mask) * _pool(want, mask), axis=-1)
        assert np.all(cos > 0.999), cos


def test_wrapper_runs_plain_on_cpu_without_launching():
    x, _, bias, weights = _inputs(1)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(bias),
            *[torch.from_numpy(w) for w in weights])
    before = dict(layer.launches)
    got = layer.fused_bert_layer(*args, nh=NH)
    want = layer.bert_layer_plain(*args, nh=NH)
    assert torch.equal(got, want)
    assert layer.launches == before


def test_no_bias_equals_zero_bias():
    x, _, _, weights = _inputs(2)
    args = [torch.from_numpy(w) for w in weights]
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        layer.bert_layer_plain(xt, None, *args, nh=NH).numpy(),
        layer.bert_layer_plain(xt, torch.zeros(B, S), *args, nh=NH).numpy())

