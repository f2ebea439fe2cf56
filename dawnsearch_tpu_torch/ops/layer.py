"""One post-LN BERT layer: the K1 and K4 CUDA kernels and their plain twins.

Counterparts of dawnsearch_tpu/ops/layer.py::fused_bert_layer (K1, the
whole-layer Pallas kernel) and ::fused_bert_layer_i8 (K4, the same layer
with W8A8 projections). K1's math is the reference's, rounding point for
rounding point (ops/layer.py:115-154), with dt the compute dtype (x's):

    qkv = dt(x·Wqkv + b)
    ctx = dt(softmax(q·kᵀ/√hd + bias [+ rel])·v)   p rounded to dt before PV,
                                              1/Σp from the f32 p, after PV
    x1  = dt(LN(ctx·Wo + bo + x))
    y   = LN(GELU(x1·W1 + b1)·W2 + b2 + x1)   (h rounded to dt; GELU with
                                              the A&S 7.1.26 erf polynomial)

K4's (ops/layer.py:157-211) quantizes each projection's input per row
(`s = max(rowabsmax, 1e-6)`, codes `round(a·(127/s))`: `quant_rows`),
multiplies the i8 codes with i8 weight codes exactly, and scales back
`f32(acc)·(s·f32(1/127))·ws`. qkv is rounded to the compute dtype; the
attention context, x1 and h stay f32; GELU uses the A&S 7.1.26 erf
polynomial. K4's attention sums in one fixed order
(`attention_f32_plain`), which its kernel follows. Weights are quantized
once per column from the f32 parameters (`quant_cols`) and laid out
(out, in) when the model is built (`i8_weight`): the kernel's s8 wgmma
reads both operands K-major. K4 and its twin take each matrix as that
(codes (N, K), scales (N,)) pair.

`fused_bert_layer` launches csrc/layer.cu's GEMMs and csrc/attention.cu's
attention (five launches), `fused_bert_layer_i8` csrc/layer_i8.cu (seven
launches from one C call), for a CUDA tensor; each runs its plain twin
(`bert_layer_plain`, `bert_layer_i8_plain`) for a CPU tensor. There is no
fallback between the two: a CUDA input a kernel does not take raises. On
the card both take bf16 or f32 activations (f32: the kernels' f32
instances, counted under `_f32` names) and the reference's envelope:
H = nh·hd with 128 % hd == 0 and H % 128 == 0, I % 128 == 0, S % 16 == 0,
S <= 512. K1 at bf16 takes its matrices in bf16; K1 at f32 on the card
computes every product 3xTF32 (hi·hi + hi·lo + lo·hi of TF32 operands,
`split_tf32`) and takes each matrix as the (W_hi, W_lo) pair of
`tf32_pair`, made once when the model is built, as K4 takes (codes,
scales); a matrix in another form or dtype is refused.

Both take the reference's optional `rel_bias` (ops/layer.py:247-296,
`has_rel`): a (nh, S, S) f32 score bias every sequence shares, MPNet's
relative-position bias (models/mpnet.py). It is added after the key bias,
`s = ((f32(q·k)·scale) + bias) + rel`, three separately rounded f32 steps
in the plain twins as in the kernels.

Weights keep the JAX layout: (in, out) matrices, 1-D biases and LN
parameters; K1's matrices in the compute dtype, the rest f32. The plain
twins take the (in, out) matrices at every dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops._cuda import (MAX_LN_WIDTH, check_matrix,
                                           check_tensor)
from dawnsearch_tpu_torch.ops.ffn import erf_poly
from dawnsearch_tpu_torch.ops.vector import layer_norm

# Layer launches of the CUDA kernels in this process (one per call, each
# being several CUDA launches), by METRICS name (_cuda.count); a call with
# rel_bias counts under its own `_rel` name
launches = {f"kernel_bert_layer{k}{r}{f}": 0 for k in ("", "_i8")
            for r in ("", "_rel") for f in ("", "_f32")}

MAX_SEQ = 512
INV127 = 1.0 / 127.0  # folded to f32(1/127) in f32 products, as the reference


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 x -> (hi, lo), the 3xTF32 split: hi is x rounded to TF32 (10
    explicit mantissa bits: the low 13 bits of the f32 cleared) to nearest
    with ties away from zero, as `cvt.rna.tf32.f32` rounds, and lo is
    x - hi (exact) rounded the same way. x = hi + lo within 2^-22·|x|
    while lo is a normal number (|x| >= 2^-102); hi is inf only within
    half a TF32 step of f32's largest value. The twin of csrc/sm90.cuh's
    split_tf32, which splits K1's f32 activations in registers."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    x = x.float().contiguous()
    hi = rna(x)
    return hi, rna(x - hi)


def tf32_pair(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) f32 matrix -> (W_hi, W_lo), each (N, K) f32 contiguous:
    split_tf32 of wᵀ. The form in which K1's f32 GEMM on the card reads a
    weight (TF32 wgmma reads both operands K-major); made once when a
    model is built."""
    return split_tf32(w.float().t().contiguous())


def bert_layer_plain(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1,
                     w2, b2, fln_s, fln_b, *, nh: int, eps: float = 1e-12,
                     rel_bias=None) -> torch.Tensor:
    """(B, S, H) x + (B, S) f32 additive key bias (or None) + optional
    (nh, S, S) f32 rel_bias -> (B, S, H) in x's dtype. Products are f32
    products of compute-dtype operands, rounded where the kernel rounds."""
    B, S, H = x.shape
    hd = H // nh
    dt = x.dtype

    def mm(a, w):
        return a.float() @ w.to(dt).float()

    x2d = x.reshape(B * S, H)
    qkv = (mm(x2d, qkv_w) + qkv_b.float()).to(dt)
    q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.split(H, dim=-1))
    s = _biased(q.float() @ k.float().transpose(-1, -2), hd, bias, rel_bias)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / p.sum(dim=-1, keepdim=True)
    ctx = (p.to(dt).float() @ v.float()) * inv
    ctx = ctx.transpose(1, 2).reshape(B * S, H).to(dt)
    att = mm(ctx, ao_w) + ao_b.float() + x2d.float()
    x1 = layer_norm(att, aln_s, aln_b, eps).to(dt)
    h = mm(x1, w1) + b1.float()
    h = (0.5 * h * (1.0 + erf_poly(h * 2.0 ** -0.5))).to(dt)
    y = mm(h, w2) + b2.float() + x1.float()
    return layer_norm(y, fln_s, fln_b, eps).reshape(B, S, H).to(dt)


def _biased(dots, hd: int, bias, rel_bias):
    """(B, nh, S, S) f32 dots -> ((dots·scale) + bias) + rel, each step
    rounded once (the kernels' order)."""
    s = dots * (1.0 / math.sqrt(hd))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if rel_bias is not None:
        s = s + rel_bias.float()[None]
    return s


def fused_bert_layer(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1,
                     w2, b2, fln_s, fln_b, *, nh: int, eps: float = 1e-12,
                     rel_bias=None) -> torch.Tensor:
    """K1: one BERT layer, the CUDA kernels for a CUDA x, the plain
    version for a CPU x (same signature as bert_layer_plain)."""
    if not x.is_cuda:
        return bert_layer_plain(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s,
                                aln_b, w1, b1, w2, b2, fln_s, fln_b, nh=nh,
                                eps=eps, rel_bias=rel_bias)
    return _layer_cuda(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1,
                       b1, w2, b2, fln_s, fln_b, nh=nh, eps=eps,
                       rel_bias=rel_bias)


def _check_layer(what: str, x, bias, rel_bias, nh: int, I: int):
    """Dtype and envelope of a whole-layer kernel's input; returns the
    bias to pass (zeros for None) and rel_bias's pointer (None for none)."""
    B, S, H = x.shape
    hd = H // nh if nh > 0 else 0
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or f32 activations on CUDA, got "
                         f"{x.dtype}")
    if (hd == 0 or H != nh * hd or 128 % hd or H % 128 or I % 128 or S % 16
            or S > MAX_SEQ):
        raise ValueError(f"{what} needs H = nh·hd with 128 % hd == 0, "
                         f"H % 128 == 0, I % 128 == 0, S % 16 == 0 and "
                         f"S <= {MAX_SEQ}; got H={H} nh={nh} I={I} S={S}")
    check_tensor(x, f"{what} x", x.dtype, (B, S, H), x.device)
    if bias is None:
        bias = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    check_tensor(bias, f"{what} bias", torch.float32, (B, S), x.device)
    if rel_bias is None:
        return bias, None
    check_tensor(rel_bias, f"{what} rel_bias", torch.float32, (nh, S, S),
                 x.device)
    return bias, rel_bias.data_ptr()


def _check_vectors(what: str, dev, H: int, I: int, **vectors) -> None:
    for name, t in vectors.items():
        n = 3 * H if name == "qkv_b" else I if name == "b1" else H
        check_tensor(t, f"{what} {name}", torch.float32, (n,), dev)


def _counter(base: str, rel, x) -> str:
    """The METRICS name of one layer launch: `_rel` with a rel_bias,
    `_f32` for the f32 instance."""
    return (base + ("_rel" if rel else "")
            + ("_f32" if x.dtype == torch.float32 else ""))


def _layer_cuda(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1, b1, w2,
                b2, fln_s, fln_b, *, nh: int, eps: float,
                rel_bias) -> torch.Tensor:
    B, S, H = x.shape
    I = b1.shape[0]
    dev = x.device
    bias, rel = _check_layer("K1", x, bias, rel_bias, nh, I)
    dt = x.dtype
    for name, w, (k, n) in (("qkv_w", qkv_w, (H, 3 * H)),
                            ("ao_w", ao_w, (H, H)), ("w1", w1, (H, I)),
                            ("w2", w2, (I, H))):
        check_matrix("K1", name, w, k, n, dt, dev)
    _check_vectors("K1", dev, H, I, qkv_b=qkv_b, ao_b=ao_b, aln_s=aln_s,
                   aln_b=aln_b, b1=b1, b2=b2, fln_s=fln_s, fln_b=fln_b)
    mats = [t for w in (qkv_w, ao_w, w1, w2)
            for t in (w if isinstance(w, tuple) else (w,))]
    if any(t.data_ptr() % 16 for t in (x, *mats)):
        raise ValueError("K1 reads x and the weights in 16-byte vectors: "
                         "their storage must be 16-byte aligned")

    M, hd = B * S, H // nh
    f32 = int(dt == torch.float32)
    x2d = x.view(M, H)
    qkv = _gemm(x2d, qkv_w, qkv_b, 0)
    # q, k and v are column views of qkv (row stride 3H), as K5 reads them;
    # the C entry is called directly so K5's launch counter counts K5 only.
    # f32: the 3xTF32 kernel, f32 in and out, p unrounded
    ctx = torch.empty((M, H), dtype=dt, device=dev)
    q, es = qkv.data_ptr(), qkv.element_size()
    _cuda.check(_cuda.lib().dawn_attention(
        q, q + H * es, q + 2 * H * es, bias.data_ptr(), rel, ctx.data_ptr(),
        B, nh, S, hd, S * 3 * H, hd, 3 * H, S * H, hd, H,
        1.0 / math.sqrt(hd), f32, f32, 0, _cuda.stream_handle(x)),
        "K1 attention")
    x1 = _gemm(ctx, ao_w, ao_b, 2, x2d, aln_s, aln_b, eps)
    h = _gemm(x1, w1, b1, 1)
    y = _gemm(h, w2, b2, 2, x1, fln_s, fln_b, eps)
    _cuda.count(launches, _counter("kernel_bert_layer", rel, x))
    return y.view(B, S, H)


_EPI_NAMES = ("K1 projection + bias", "K1 projection + GELU",
              "K1 projection + LN")


def _gemm(a, w, bias, epi: int, resid=None, ln_s=None, ln_b=None,
          eps: float = 1e-12) -> torch.Tensor:
    """One of K1's projections on the card (csrc/layer.cu::dawn_bert_gemm,
    the TMA + wgmma kernel): (M, K) a · the (K, N) matrix + bias, then epi
    0: nothing, 1: the GELU, 2: + the (M, N) resid and LayerNorm(ln_s,
    ln_b, eps); out (M, N) in a's dtype. w: bf16, the (K, N) matrix; f32,
    its (W_hi, W_lo) pair (tf32_pair, each (N, K)), multiplied 3xTF32. N a
    multiple of 128 at epi 0; at epi 1 and 2 a multiple of 8 (bf16) or 4
    (f32): the last column tile of an N that is not a multiple of 128 is
    masked (K7's widths). a, w and resid
    contiguous in a's dtype, 16-byte aligned, the vectors f32:
    the caller checks them (_layer_cuda; chip_smoke.py and the card tests
    time and hold each projection alone). Counts nothing: K1 counts its
    layer."""
    M, K = a.shape
    hi, lo = w if isinstance(w, tuple) else (w, None)
    N = hi.shape[0] if lo is not None else hi.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ptr = [None if t is None else t.data_ptr() for t in (resid, ln_s, ln_b)]
    _cuda.check(_cuda.lib().dawn_bert_gemm(
        a.data_ptr(), hi.data_ptr(), None if lo is None else lo.data_ptr(),
        bias.data_ptr(), *ptr, out.data_ptr(), M, N, K, epi, eps,
        int(a.dtype == torch.float32), _cuda.stream_handle(a)),
        _EPI_NAMES[epi])
    return out


# -- K4 ---------------------------------------------------------------------

def quant_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) f32 weights -> (i8 codes (K, N), f32 per-column scales (N,)):
    scale = max(column absmax, 1e-12) / 127, codes = round(w / scale),
    half to even. The reference's _quant_cols (ops/layer.py:214-218) as
    written: both divisions are true f32 divisions (a tensor divisor: torch
    on CUDA turns a division by a scalar into a product with its
    reciprocal)."""
    w = w.float()
    amax = w.abs().amax(dim=0).clamp_min(1e-12)
    s = torch.div(amax, torch.full_like(amax, 127.0))
    return torch.round(w / s).to(torch.int8), s


def i8_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, N) f32 weights -> (i8 codes (N, K) contiguous, f32 scales
    (N,)): quant_cols with the codes transposed, the form K4 and its twin
    take (the kernel's s8 wgmma reads both operands K-major). Made once
    when a model is built; no (K, N) copy is kept."""
    codes, scales = quant_cols(w)
    return codes.t().contiguous(), scales


def quant_rows(a32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) f32 activations -> (i8 codes (M, K), f32 row factors (M,)):
    s = max(row absmax, 1e-6), codes = round(a·(127/s)) half to even,
    factor s·f32(1/127); the reference's _mm_i8 quantization
    (ops/layer.py:157-172) and the twin of csrc/layer_i8.cu's
    quant_rows_kernel."""
    s = a32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    aq = torch.round(a32 * torch.div(torch.full_like(s, 127.0), s))
    return aq.to(torch.int8), (s * INV127).reshape(-1)


def _mm_codes(aq: torch.Tensor, rf: torch.Tensor, wq: torch.Tensor,
              ws: torch.Tensor) -> torch.Tensor:
    """(M, K) i8 codes with row factors rf @ the (N, K) weight codes ->
    (M, N) f32 `(f32(acc)·rf)·ws`. The i8 product is taken in f64, which
    is exact here (|acc| <= 127²·K < 2^53) on the CPU and on CUDA, and
    rounded to f32 once, as s32 -> f32 rounds."""
    acc = (aq.double() @ wq.double().T).float()
    return acc * rf.reshape(-1, 1) * ws.float()


def _mm_i8(a32: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor
           ) -> torch.Tensor:
    """(M, K) f32 @ per-column i8 weights (codes (N, K)) -> (M, N) f32,
    the reference's _mm_i8 (ops/layer.py:157-172)."""
    return _mm_codes(*quant_rows(a32), wq, ws)


def attention_f32_plain(qkv, bias, B, S, H, nh, rel_bias=None
                        ) -> torch.Tensor:
    """(M, 3H) bf16 or f32 qkv -> (M, H) f32 context with every sum in the
    order of K4's attention step (csrc/attention.cu's fixed-order kernel):
    scores over the head dim ascending, the softmax sum and PV over keys
    ascending, p rounded to qkv's dtype before PV. Each product and each
    sum rounds once, on its own (eager torch fuses nothing): a bf16 x bf16
    product is exact in f32; an f32 x f32 one is rounded, as the kernel's
    f32 instance rounds it (`__fmul_rn`, then `__fadd_rn`). The contract of
    bert_layer_plain's attention, unrounded; the fixed order is what keeps
    K4 and this twin equal through K4's next quantization (the kernel's
    note says why)."""
    hd = H // nh
    q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2).float()
               for t in qkv.split(H, dim=-1))
    s = torch.zeros((B, nh, S, S), dtype=torch.float32, device=qkv.device)
    for d in range(hd):
        s = s + q[..., d:d + 1] * k[..., d].unsqueeze(-2)
    s = _biased(s, hd, bias, rel_bias)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pb = p.to(qkv.dtype).float()
    l = torch.zeros((B, nh, S, 1), dtype=torch.float32, device=qkv.device)
    o = torch.zeros((B, nh, S, hd), dtype=torch.float32, device=qkv.device)
    for j in range(S):
        l = l + p[..., j:j + 1]
        o = o + pb[..., j:j + 1] * v[..., j:j + 1, :]
    o = o * (1.0 / l)
    return o.transpose(1, 2).reshape(B * S, H)


def bert_layer_i8_plain(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1,
                        b1, w2, b2, fln_s, fln_b, *, nh: int,
                        eps: float = 1e-12, rel_bias=None) -> torch.Tensor:
    """(B, S, H) x + (B, S) f32 additive key bias (or None) + optional
    (nh, S, S) f32 rel_bias -> (B, S, H) in x's dtype; each of qkv_w, ao_w,
    w1, w2 is a (codes (N, K), scales) pair from i8_weight."""
    B, S, H = x.shape
    dt = x.dtype
    x32 = x.reshape(B * S, H).float()
    qkv = (_mm_i8(x32, *qkv_w) + qkv_b.float()).to(dt)
    ctx = attention_f32_plain(qkv, bias, B, S, H, nh, rel_bias)  # f32
    att = _mm_i8(ctx, *ao_w) + ao_b.float() + x32
    x1 = layer_norm(att, aln_s, aln_b, eps)                      # f32
    h = _mm_i8(x1, *w1) + b1.float()
    h = 0.5 * h * (1.0 + erf_poly(h * 2.0 ** -0.5))              # f32
    y = _mm_i8(h, *w2) + b2.float() + x1
    return layer_norm(y, fln_s, fln_b, eps).reshape(B, S, H).to(dt)


def fused_bert_layer_i8(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s, aln_b, w1,
                        b1, w2, b2, fln_s, fln_b, *, nh: int,
                        eps: float = 1e-12, rel_bias=None) -> torch.Tensor:
    """K4: one BERT layer with W8A8 projections, the CUDA kernel for a
    CUDA x, bert_layer_i8_plain for a CPU x (same signature; each matrix
    argument is its (i8 codes (N, K), f32 scales) pair from i8_weight, on
    either device)."""
    if not x.is_cuda:
        return bert_layer_i8_plain(x, bias, qkv_w, qkv_b, ao_w, ao_b, aln_s,
                                   aln_b, w1, b1, w2, b2, fln_s, fln_b, nh=nh,
                                   eps=eps, rel_bias=rel_bias)
    B, S, H = x.shape
    I = w1[0].shape[0]
    dev = x.device
    bias, rel = _check_layer("K4", x, bias, rel_bias, nh, I)
    if H > MAX_LN_WIDTH:
        raise ValueError(f"K4's LayerNorm GEMMs span a cluster of H / 128 "
                         f"<= 16 CTAs: H <= {MAX_LN_WIDTH}, got H={H}")
    for name, (q, s), (n, k) in (("qkv_w", qkv_w, (3 * H, H)),
                                 ("ao_w", ao_w, (H, H)), ("w1", w1, (I, H)),
                                 ("w2", w2, (H, I))):
        check_tensor(q, f"K4 {name} codes", torch.int8, (n, k), dev)
        check_tensor(s, f"K4 {name} scales", torch.float32, (n,), dev)
    _check_vectors("K4", dev, H, I, qkv_b=qkv_b, ao_b=ao_b, aln_s=aln_s,
                   aln_b=aln_b, b1=b1, b2=b2, fln_s=fln_s, fln_b=fln_b)

    M, W, dt = B * S, max(H, I), x.dtype
    y = torch.empty((B, S, H), dtype=dt, device=dev)
    scratch = (torch.empty((M, W), dtype=torch.int8, device=dev),
               torch.empty((M,), dtype=torch.float32, device=dev),
               torch.empty((M, 3 * H), dtype=dt, device=dev),
               torch.empty((M, W), dtype=torch.float32, device=dev),
               torch.empty((M, H), dtype=torch.float32, device=dev))
    x1_codes = (torch.empty((M, H), dtype=torch.int8, device=dev),
                torch.empty((M,), dtype=torch.float32, device=dev),
                torch.empty((M, I // 128), dtype=torch.float32, device=dev))
    if any(t.data_ptr() % 16 for t in (x, qkv_w[0], ao_w[0], w1[0], w2[0])):
        raise ValueError("K4 reads x and the weight codes in 16-byte "
                         "vectors: their storage must be 16-byte aligned")
    ptrs = [t.data_ptr() for t in (
        x, bias, *qkv_w, qkv_b, *ao_w, ao_b, aln_s, aln_b, *w1, b1, *w2, b2,
        fln_s, fln_b, y, *scratch)] + [rel] + [t.data_ptr() for t in x1_codes]
    _cuda.check(_cuda.lib().dawn_bert_layer_i8(
        (ctypes.c_void_p * len(ptrs))(*ptrs), B, S, H, nh, I, eps,
        int(dt == torch.float32), _cuda.stream_handle(x)), "K4 layer")
    _cuda.count(launches, _counter("kernel_bert_layer_i8", rel, x))
    return y


_I8_EPI_NAMES = ("K4 qkv projection", "K4 FFN-in projection + GELU",
                 "K4 LayerNorm projection")


def _gemm_i8(a, w, bias, epi: int, *, dt, rf=None, part=None, resid=None,
             ln_s=None, ln_b=None, eps: float = 1e-12):
    """One of K4's projections on the card as the layer runs it
    (csrc/layer_i8.cu::dawn_i8_gemm, the TMA + s8 wgmma GEMM), w its
    (codes (N, K), scales) pair:
      epi 0, qkv: the (M, K) codes `a` with row factors rf -> (M, N) dt;
      epi 1, FFN in + GELU: codes a, rf -> (f32 h, (M, N / 128) absmax of
        h over each 128 columns);
      epi 2 on codes a, rf, attention out: + the dt resid, LayerNorm ->
        (f32 x1, x1's codes, x1's row factors);
      epi 2 on f32 a, FFN out: a quantized in the GEMM, its row absmax the
        max of `part` (M, K / 128); + the f32 resid, LayerNorm -> dt.
    The caller checks shapes, dtypes and alignment (chip_smoke.py and the
    card tests time and hold each alone). Counts nothing: K4 counts its
    layer."""
    M, K = a.shape
    wq, ws = w
    N = wq.shape[0]
    dev = a.device
    quantize = a.dtype == torch.float32
    quant_out = epi == 2 and not quantize
    out_dt = torch.float32 if epi == 1 or quant_out else dt
    out = torch.empty((M, N), dtype=out_dt, device=dev)
    codes = (torch.empty((M, K), dtype=torch.int8, device=dev) if quantize
             else a)
    q_out = rf_out = None
    if quant_out:
        q_out = torch.empty((M, N), dtype=torch.int8, device=dev)
        rf_out = torch.empty((M,), dtype=torch.float32, device=dev)
    if epi == 1:
        part = torch.empty((M, N // 128), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _cuda.check(_cuda.lib().dawn_i8_gemm(
        codes.data_ptr(), ptr(rf), ptr(a) if quantize else None, ptr(part),
        wq.data_ptr(), ws.data_ptr(), bias.data_ptr(), ptr(resid), ptr(ln_s),
        ptr(ln_b), out.data_ptr(), ptr(q_out), ptr(rf_out), M, N, K, epi,
        int(dt == torch.float32), eps, _cuda.stream_handle(a)),
        _I8_EPI_NAMES[epi])
    if quant_out:
        return out, q_out, rf_out
    return (out, part) if epi == 1 else out
