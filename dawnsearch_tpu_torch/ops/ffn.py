"""The per-op encoder's fused FFN (K7): the CUDA kernels and their plain twin.

Counterpart of dawnsearch_tpu/ops/ffn.py::fused_ffn. Same contract,
rounding point for rounding point (ffn.py:51-66):

    h   = dtype(GELU(x·W1 + b1))     GELU with the A&S 7.1.26 erf polynomial
    y   = (h·W2 + b2) + x            f32
    out = dtype(LN(y))               LayerNorm in f32

`fused_ffn` runs K7 for a CUDA tensor and `ffn_plain` for a CPU tensor.
There is no fallback between the two: a CUDA input K7 does not take
raises, and no error is caught and retried on another path. K7 is one C
call (csrc/ffn.cu::dawn_ffn) that makes two launches of the TMA + wgmma
GEMM of K1's projections (csrc/gemm.cuh): x·W1 + b1 -> GELU into an
(M, I) h in device memory, then h·W2 + b2 + x -> LayerNorm over a
thread-block cluster. It counts once a call, as `kernel_ffn`, or
`kernel_ffn_f32` at f32.

K7's envelope on CUDA: x (M, H) in bf16 or f32, contiguous; H and I
multiples of 8; H <= 2048 (the LayerNorm spans a cluster of ceil(H / 128)
<= 16 CTAs, refused if the card cannot place it); x and the matrices
16-byte aligned. At bf16 the matrices are the (H, I) and (I, H) bf16
matrices of the reference; at f32 each is its (W_hi, W_lo) pair from
ops/layer.py::tf32_pair (each (out, in) f32, made once when the model is
built), multiplied 3xTF32, and a plain f32 matrix is refused. The plain
twin takes the (in, out) matrices at either dtype.
"""

from __future__ import annotations

import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops._cuda import (MAX_LN_WIDTH, check_matrix,
                                           check_tensor)
from dawnsearch_tpu_torch.ops.vector import layer_norm

# CUDA launches in this process, by METRICS name (_cuda.count): one a
# fused_ffn call, which is two launches of the GEMM
launches = {"kernel_ffn": 0, "kernel_ffn_f32": 0}


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), the
    polynomial of the reference kernel (dawnsearch_tpu/ops/ffn.py:36-46)."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def ffn_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float = 1e-12
              ) -> torch.Tensor:
    """(M, H) x -> LN(x + GELU(x·w1 + b1)·w2 + b2) in x's dtype; products
    are f32 products of compute-dtype operands."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    h = (0.5 * h * (1.0 + erf_poly(h * 2.0 ** -0.5))).to(dt)
    y = (h.float() @ w2.to(dt).float() + b2.float()) + x.float()
    return layer_norm(y, ln_scale, ln_bias, eps).to(dt)


def fused_ffn(x, w1, b1, w2, b2, ln_scale, ln_bias, eps: float = 1e-12
              ) -> torch.Tensor:
    """K7: the CUDA kernels for a CUDA x, ffn_plain for a CPU x (same
    signature as ffn_plain; on CUDA at f32, w1 and w2 as tf32_pair pairs)."""
    if not x.is_cuda:
        return ffn_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps)
    M, H = x.shape
    I = b1.shape[0]
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"K7 takes bf16 or f32 activations on CUDA, got {dt}")
    if H % 8 or I % 8 or H > MAX_LN_WIDTH:
        raise ValueError(f"K7 needs H and I multiples of 8 and H <= "
                         f"{MAX_LN_WIDTH} (its LayerNorm spans a cluster of "
                         f"ceil(H / 128) <= 16 CTAs); got H={H} I={I}")
    check_tensor(x, "K7 x", dt, (M, H), dev)
    check_matrix("K7", "w1", w1, H, I, dt, dev)
    check_matrix("K7", "w2", w2, I, H, dt, dev)
    for name, t, n in (("b1", b1, I), ("b2", b2, H), ("ln_scale", ln_scale, H),
                       ("ln_bias", ln_bias, H)):
        check_tensor(t, f"K7 {name}", f32, (n,), dev)
    (w1, w1_lo), (w2, w2_lo) = (w if isinstance(w, tuple) else (w, None)
                                for w in (w1, w2))
    if any(t is not None and t.data_ptr() % 16
           for t in (x, w1, w1_lo, w2, w2_lo)):
        raise ValueError("K7 reads x and the matrices in 16-byte vectors: "
                         "their storage must be 16-byte aligned")
    is_f32 = int(dt == f32)
    h = torch.empty((M, I), dtype=dt, device=dev)
    out = torch.empty((M, H), dtype=dt, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _cuda.check(_cuda.lib().dawn_ffn(
        x.data_ptr(), w1.data_ptr(), ptr(w1_lo), b1.data_ptr(), w2.data_ptr(),
        ptr(w2_lo), b2.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        h.data_ptr(), out.data_ptr(), M, H, I, eps, is_f32,
        _cuda.stream_handle(x)), "K7 FFN")
    _cuda.count(launches, "kernel_ffn_f32" if is_f32 else "kernel_ffn")
    return out
