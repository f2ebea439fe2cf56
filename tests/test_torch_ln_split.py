"""The GEMM ring's cluster LayerNorm order and its build key, on the CPU.

The GEMM ring's LayerNorm epilogue (csrc/gemm.cuh) spreads a row over a
cluster of ceil(N / 128) CTAs: each CTA sums its own columns, and the
row's mean and variance come from the CTAs' partial sums added in rank
order. `ops/vector.py::layer_norm_from_partials` writes that order out in
plain torch; here it is held against `layer_norm` (the twins' LayerNorm)
for the cluster sizes K1 runs: 3 (MiniLM), 6 (BERT-base), 8 (BERT-large)
and 16 (the largest cluster, H = 2048), and at the ragged widths K7 runs
on the same epilogue, chunks of 128 columns with a short last one: 312
(TinyBERT, 128 + 128 + 56), 1200 (9 x 128 + 48) and 2040 (15 x 128 +
120). Tolerance: max |d| <= 1e-5 on the
normalised rows, and both within 1e-5 of an f64 LayerNorm. The two differ
only in the order of f32 sums over at most 2048 terms (relative error
about 1e-7 of the sum), far below one bf16 step (3.9e-3) of K1's output.

The kernels build once per checkout, keyed on a hash of csrc/*.cu, the
headers they include (csrc/*.cuh) and nvcc's flags
(ops/_cuda.py::library_path): a change to sm90.cuh, the PTX wrappers of
the wgmma GEMM and the mma.sync attention, must change the key, or a
checkout would load a library built from the old header.
"""

import shutil

import numpy as np
import pytest
import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops.vector import layer_norm, layer_norm_from_partials

torch.set_num_threads(2)


def _rows(rng, n):
    """64 rows with a large common offset, as the residual sum gives them,
    and LayerNorm parameters."""
    y = torch.from_numpy((3.0 + 2.0 * rng.standard_normal((64, n))
                          ).astype(np.float32))
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(n)
                              ).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32))
    return y, scale, bias


def _check_bound(got, y, scale, bias):
    """max |d| <= 1e-5 against layer_norm, and both within 1e-5 of an f64
    LayerNorm."""
    want = layer_norm(y, scale, bias, 1e-12)
    assert got.dtype == torch.float32 and got.shape == y.shape
    assert float((got - want).abs().max()) <= 1e-5
    y64 = y.double()
    mean = y64.mean(-1, keepdim=True)
    exact = ((y64 - mean) / torch.sqrt((y64 - mean).square().mean(
        -1, keepdim=True) + 1e-12) * scale.double() + bias.double())
    assert float((got.double() - exact).abs().max()) <= 1e-5
    assert float((want.double() - exact).abs().max()) <= 1e-5


@pytest.mark.parametrize("parts", [3, 6, 8, 16])
def test_cluster_order_layer_norm_matches_layer_norm(parts):
    rng = np.random.default_rng(parts)
    y, scale, bias = _rows(rng, 128 * parts)
    got = layer_norm_from_partials(y, scale, bias, 1e-12)
    _check_bound(got, y, scale, bias)


@pytest.mark.parametrize("n,last", [(312, 56), (1200, 48), (2040, 120)])
def test_ragged_cluster_layer_norm_matches_layer_norm(n, last):
    """A ragged N: ceil(n / 128) CTAs, the last with `last` columns; each
    CTA's partials cover its valid columns and the mean divides by n."""
    rng = np.random.default_rng(n)
    y, scale, bias = _rows(rng, n)
    assert n - 128 * (n // 128) == last
    got = layer_norm_from_partials(y, scale, bias, 1e-12)
    _check_bound(got, y, scale, bias)


@pytest.mark.parametrize("header", ["sm90.cuh", "common.cuh"])
def test_build_key_follows_each_header(tmp_path, monkeypatch, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", str(csrc))
    before = _cuda.library_path()
    assert _cuda.library_path() == before            # a pure function
    with open(csrc / header, "a") as f:
        f.write("\n// touched\n")
    assert _cuda.library_path() != before
