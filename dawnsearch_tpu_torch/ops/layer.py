"""One post-LN BERT layer: the K1 CUDA kernel and its plain twin.

Counterpart of dawnsearch_tpu/ops/layer.py::fused_bert_layer (the
whole-layer Pallas kernel). The math is the reference's, rounding point
for rounding point (ops/layer.py:115-154):

    qkv = bf16(x·Wqkv + b)
    ctx = bf16(softmax(q·kᵀ/√hd + bias)·v)   p rounded to bf16 before PV,
                                              1/Σp from the f32 p, after PV
    x1  = bf16(LN(ctx·Wo + bo + x))
    y   = LN(GELU_erf(x1·W1 + b1)·W2 + b2 + x1)   (h rounded to bf16)

`fused_bert_layer` launches the hand-written kernel
(csrc/layer.cu: five launches — three GEMM epilogues and attention) for a
CUDA tensor and runs `bert_layer_plain` for a CPU tensor. There is no
fallback between the two: a CUDA input the kernel does not take raises.

Weights keep the JAX layout: (in, out) matrices, 1-D biases and LN
parameters; matrices in the compute dtype, the rest f32.
"""

from __future__ import annotations

import math

import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops._cuda import check_tensor
from dawnsearch_tpu_torch.ops.vector import layer_norm

# Layer launches of the CUDA kernel in this process (one per call, each
# being five CUDA launches), by METRICS name (_cuda.count).
launches = {"kernel_bert_layer": 0}


def bert_layer_plain(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1,
                     w2, b2, fln_s, fln_b, *, nh: int,
                     eps: float = 1e-12) -> torch.Tensor:
    """(B, S, H) x + (B, S) f32 additive key bias (or None) -> (B, S, H)
    in x's dtype. Products are f32 products of compute-dtype operands,
    rounded where the kernel rounds."""
    B, S, H = x.shape
    hd = H // nh
    dt = x.dtype

    def mm(a, w):
        return a.float() @ w.to(dt).float()

    x2d = x.reshape(B * S, H)
    qkv = (mm(x2d, qkv_w) + qkv_b.float()).to(dt)
    q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(H, dim=-1))
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / p.sum(dim=-1, keepdim=True)
    ctx = (p.to(dt).float() @ v.float()) * inv
    ctx = ctx.transpose(1, 2).reshape(B * S, H).to(dt)
    att = mm(ctx, ao_w) + ao_b.float() + x2d.float()
    x1 = layer_norm(att, aln_s, aln_b, eps).to(dt)
    h = mm(x1, w1) + b1.float()
    h = (0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))).to(dt)
    y = mm(h, w2) + b2.float() + x1.float()
    return layer_norm(y, fln_s, fln_b, eps).reshape(B, S, H).to(dt)


def fused_bert_layer(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1,
                     w2, b2, fln_s, fln_b, *, nh: int,
                     eps: float = 1e-12) -> torch.Tensor:
    """One BERT layer: the CUDA kernel for a CUDA x, the plain version
    for a CPU x (same signature as bert_layer_plain)."""
    if not x.is_cuda:
        return bert_layer_plain(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s,
                                aln_b, w1, b1, w2, b2, fln_s, fln_b, nh=nh,
                                eps=eps)
    return _layer_cuda(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1,
                       b1, w2, b2, fln_s, fln_b, nh=nh, eps=eps)


def _layer_cuda(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1, w2,
                b2, fln_s, fln_b, *, nh: int, eps: float) -> torch.Tensor:
    B, S, H = x.shape
    I = w1.shape[1]
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K1 takes bf16 activations on CUDA, got {x.dtype} "
                         "(f32 compute runs only in bert_layer_plain)")
    if H != nh * 32 or H % 128 or I % 128 or S % 16:
        raise ValueError(f"K1 needs head dim 32, H % 128 == 0, I % 128 == 0 "
                         f"and S % 16 == 0; got H={H} nh={nh} I={I} S={S}")
    bf, f32 = torch.bfloat16, torch.float32
    check_tensor(x, "K1 x", bf, (B, S, H), dev)
    for name, t, shape in (("qkv_w", qkv_w, (H, 3 * H)), ("ao_w", ao_w, (H, H)),
                           ("w1", w1, (H, I)), ("w2", w2, (I, H))):
        check_tensor(t, f"K1 {name}", bf, shape, dev)
    for name, t, n in (("qkv_b", qkv_b, 3 * H), ("ao_b", ao_b, H),
                       ("aln_s", aln_s, H), ("aln_b", aln_b, H), ("b1", b1, I),
                       ("b2", b2, H), ("fln_s", fln_s, H), ("fln_b", fln_b, H)):
        check_tensor(t, f"K1 {name}", f32, (n,), dev)
    if bias is None:
        bias = torch.zeros((B, S), dtype=f32, device=dev)
    check_tensor(bias, "K1 bias", f32, (B, S), dev)

    M = B * S
    lib = _cuda.lib()
    stream = _cuda.stream_handle(x)
    qkv = torch.empty((M, 3 * H), dtype=bf, device=dev)
    ctx = torch.empty((M, H), dtype=bf, device=dev)
    x1 = torch.empty((M, H), dtype=bf, device=dev)
    h = torch.empty((M, I), dtype=bf, device=dev)
    y = torch.empty((B, S, H), dtype=bf, device=dev)
    null = None
    gemm = lib.dawn_bert_gemm
    _cuda.check(gemm(x.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(), null,
                     null, null, qkv.data_ptr(), M, 3 * H, H, 0, eps, stream),
                "K1 qkv projection")
    _cuda.check(lib.dawn_bert_attention(qkv.data_ptr(), bias.data_ptr(),
                                        ctx.data_ptr(), B, S, H, nh, stream),
                "K1 attention")
    _cuda.check(gemm(ctx.data_ptr(), ao_w.data_ptr(), ao_b.data_ptr(),
                     x.data_ptr(), aln_s.data_ptr(), aln_b.data_ptr(),
                     x1.data_ptr(), M, H, H, 2, eps, stream),
                "K1 attention out + LN")
    _cuda.check(gemm(x1.data_ptr(), w1.data_ptr(), b1.data_ptr(), null, null,
                     null, h.data_ptr(), M, I, H, 1, eps, stream),
                "K1 FFN in + GELU")
    _cuda.check(gemm(h.data_ptr(), w2.data_ptr(), b2.data_ptr(), x1.data_ptr(),
                     fln_s.data_ptr(), fln_b.data_ptr(), y.data_ptr(), M, H, I,
                     2, eps, stream),
                "K1 FFN out + LN")
    _cuda.count(launches, "kernel_bert_layer")
    return y
