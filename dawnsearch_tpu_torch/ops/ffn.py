"""The per-op encoder's fused FFN (K7): the CUDA kernel and its plain twin.

Counterpart of dawnsearch_tpu/ops/ffn.py::fused_ffn. Same contract,
rounding point for rounding point (ffn.py:51-66):

    h   = dtype(GELU(x·W1 + b1))     GELU with the A&S 7.1.26 erf polynomial
    y   = (h·W2 + b2) + x            f32
    out = dtype(LN(y))               LayerNorm in f32

`fused_ffn` launches the hand-written kernel (csrc/ffn.cu, one launch that
keeps each row block's (rows, I) intermediate in shared memory) for a
CUDA tensor and runs `ffn_plain` for a CPU tensor. There is no fallback
between the two: a CUDA input the kernel does not take raises. On CUDA it
takes bf16 activations and matrices (WMMA), or f32 ones (compute_dtype =
"f32": CUDA-core FMAs, h unrounded; counted as `kernel_ffn_f32`), H and I
multiples of 8, and a width whose smallest row block (16 rows bf16, 8
f32) fits the SM.
"""

from __future__ import annotations

import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops._cuda import check_tensor
from dawnsearch_tpu_torch.ops.vector import layer_norm

# CUDA launches in this process, by METRICS name (_cuda.count).
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
    """K7: the CUDA kernel for a CUDA x, ffn_plain for a CPU x (same
    signature as ffn_plain; weights (H, I) and (I, H) in the x·w
    convention)."""
    if not x.is_cuda:
        return ffn_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, eps)
    M, H = x.shape
    I = w1.shape[1]
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"K7 takes bf16 or f32 activations on CUDA, got {dt}")
    check_tensor(x, "K7 x", dt, (M, H), dev)
    check_tensor(w1, "K7 w1", dt, (H, I), dev)
    check_tensor(w2, "K7 w2", dt, (I, H), dev)
    for name, t, n in (("b1", b1, I), ("b2", b2, H), ("ln_scale", ln_scale, H),
                       ("ln_bias", ln_bias, H)):
        check_tensor(t, f"K7 {name}", f32, (n,), dev)
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("K7 reads x, w1 and w2 in 16-byte vectors: their "
                         "storage must be 16-byte aligned")
    lib = _cuda.lib()
    is_f32 = int(dt == f32)
    if lib.dawn_ffn_block_rows(H, I, is_f32) == 0:
        raise ValueError(f"K7 needs H and I multiples of 8 and a "
                         f"{8 if is_f32 else 16}-row block of x, h and y in "
                         f"{dt} within the SM's shared memory; got H={H} "
                         f"I={I}")
    out = torch.empty((M, H), dtype=dt, device=dev)
    _cuda.check(lib.dawn_ffn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                             w2.data_ptr(), b2.data_ptr(), ln_scale.data_ptr(),
                             ln_bias.data_ptr(), out.data_ptr(), M, H, I, eps,
                             is_f32, _cuda.stream_handle(x)), "K7 FFN")
    _cuda.count(launches, "kernel_ffn_f32" if is_f32 else "kernel_ffn")
    return out
