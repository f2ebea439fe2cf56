"""Attention in both layouts (K5, K6) and the fused pool (K8): the CUDA
kernels and their plain twins.

Counterparts of dawnsearch_tpu/ops/attention.py:

- `fused_attention_packed` (K5): q, k, v (B, S, H) with the heads packed
  on the feature axis, H = nh·hd, 128 % hd == 0 and H % 128 == 0;
- `fused_attention` (K6): q, k, v (B, nh, S, hd), any head dim;
- `fused_mean_pool` (K8): masked (or plain) mean over S of bf16 or f32
  hidden states, then L2 normalize with eps 1e-12, f32 out.

K5 and K6 compute softmax(q·kᵀ/√hd + bias)·v with the reference's
rounding points (attention.py:63-77, :157-174): scores and softmax in f32,
p rounded to the compute dtype before PV, 1/Σp from the f32 p applied
after PV, one rounding to the output dtype. Both launch csrc/attention.cu:
K5 reads q, k and v where they lie, as column slices of the projection's
(B, S, 3H) output, with no split copy. bf16 inputs run the bf16 mma.sync
kernel; f32 inputs (compute_dtype = "f32": p unrounded, f32 out) run the
3xTF32 mma.sync kernel, and count under their own `_f32` names.

Each wrapper launches its kernel for a CUDA tensor and runs its plain twin
(`attention_packed_plain`, `attention_plain`, `mean_pool_plain`) for a
CPU tensor. There is no fallback between the two: a CUDA input the kernel
does not take raises. On CUDA, K5 and K6 take bf16 or f32, S % 16 == 0
and S <= 512 (the encoder's buckets); K8 takes contiguous bf16 or f32
hidden states of any S and any H up to POOL_MAX_H, and a bool, int32,
int64 or f32 mask of any strides, each read in its own dtype (the encoder
hands it its last hidden state and its int32 mask uncast), spread over
the card by plan_pool.
"""

from __future__ import annotations

import math

import torch

from dawnsearch_tpu_torch.ops import _cuda

# CUDA launches in this process, by METRICS name (_cuda.count).
launches = {"kernel_attention_packed": 0, "kernel_attention": 0,
            "kernel_attention_packed_f32": 0, "kernel_attention_f32": 0,
            "kernel_mean_pool": 0}

MAX_SEQ = 512

# K8's launch (csrc/pool.cu): a thread owns 8 columns; a CTA at most 512
# threads (at most 128 registers each: 512 threads fill an SM's register
# file); a sequence a cluster of at most 16 CTAs, so H <= 16 · 512 · 8.
# plan_pool spreads a small batch over clusters of at most 8 CTAs (the
# portable size: a batch of 16-CTA clusters waits on the card to place
# them, and reads twice the partials over DSMEM), each row range keeping
# at least 32 rows, while the batch's CTAs take at most half the SMs (a
# split of a batch past that costs more in its exchange than it saves:
# scripts/pool_ab.py's sweep of plans on an H100).
POOL_VEC, POOL_MAX_LANES, POOL_MAX_CLUSTER = 8, 512, 16
POOL_MAX_H = POOL_MAX_CLUSTER * POOL_MAX_LANES * POOL_VEC
POOL_SPREAD, POOL_MIN_ROWS = 8, 32
POOL_MASKS = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
              torch.float32: 3}


def attention_plain(q, k, v, bias, nh: int) -> torch.Tensor:
    """(B, nh, S, hd) q, k, v + (B, S) f32 additive key bias (or None) ->
    (B, nh, S, hd) in q's dtype."""
    hd = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / p.sum(dim=-1, keepdim=True)
    return ((p.to(q.dtype).float() @ v.float()) * inv).to(q.dtype)


def attention_packed_plain(q, k, v, bias, nh: int) -> torch.Tensor:
    """(B, S, H) q, k, v, heads on the feature axis -> (B, S, H)."""
    B, S, H = q.shape
    hd = H // nh

    def heads(t):
        return t.reshape(B, S, nh, hd).transpose(1, 2)
    out = attention_plain(heads(q), heads(k), heads(v), bias, nh)
    return out.transpose(1, 2).reshape(B, S, H)


def mean_pool_plain(hidden, mask, include_padding: bool = False
                    ) -> torch.Tensor:
    """(B, S, H) hidden + (B, S) mask -> (B, H) f32 unit rows."""
    h = hidden.float()
    if include_padding:
        pooled = h.mean(dim=1)
    else:
        w = mask.float()[..., None]
        pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    norm = torch.sqrt((pooled * pooled).sum(dim=1, keepdim=True))
    return pooled / norm.clamp_min(1e-12)


def fused_attention_packed(q, k, v, bias, nh: int) -> torch.Tensor:
    """K5: (B, S, H) q, k, v + (B, S) bias -> (B, S, H); the kernel for
    CUDA tensors, attention_packed_plain for CPU tensors."""
    if not q.is_cuda:
        return attention_packed_plain(q, k, v, bias, nh)
    B, S, H = q.shape
    hd = H // nh
    if H != nh * hd or 128 % hd or H % 128:
        raise ValueError(f"K5 needs 128 % head_dim == 0 and H % 128 == 0; "
                         f"got H={H} nh={nh}")
    _check_qkv("K5", q, k, v, (B, S, H), S)
    ld = q.stride(1)
    if q.stride() != (S * ld, ld, 1):
        raise ValueError(f"K5 reads rows of a contiguous (B, S, ld) buffer "
                         f"with unit feature stride; got strides {q.stride()}")
    out = torch.empty((B, S, H), dtype=q.dtype, device=q.device)
    _attention_cuda("kernel_attention_packed", q, k, v, bias, out, B, nh, S,
                    hd, (S * ld, hd, ld), (S * H, hd, H))
    return out


def fused_attention(q, k, v, bias, nh: int) -> torch.Tensor:
    """K6: (B, nh, S, hd) q, k, v + (B, S) bias -> (B, nh, S, hd); the
    kernel for CUDA tensors, attention_plain for CPU tensors."""
    if not q.is_cuda:
        return attention_plain(q, k, v, bias, nh)
    B, nh_, S, hd = q.shape
    if nh_ != nh or hd > 128:
        raise ValueError(f"K6 needs (B, {nh}, S, hd) with hd <= 128; "
                         f"got {tuple(q.shape)}")
    _check_qkv("K6", q, k, v, (B, nh, S, hd), S)
    if not q.is_contiguous():
        raise ValueError("K6 takes contiguous (B, nh, S, hd) tensors")
    out = torch.empty_like(q)
    strides = (nh * S * hd, S * hd, hd)
    _attention_cuda("kernel_attention", q, k, v, bias, out, B, nh, S, hd,
                    strides, strides)
    return out


def plan_pool(B: int, S: int, H: int, sms: int
              ) -> tuple[int, int, int, int]:
    """K8's launch for B sequences of S rows of width H on a card of `sms`
    SMs -> (cc, r, lanes, p): each sequence is a cluster of cc column
    chunks of `lanes` · 8 columns times r row ranges, and a CTA has p row
    lanes of `lanes` threads. Chunks start as wide as a CTA takes (512
    lanes); then, while doubling the cluster keeps the batch's CTAs on at
    most half the SMs and the cluster at most POOL_SPREAD CTAs, a range of
    at least 2 · 32 rows splits in two, else, in a sequence too short to
    split its rows, a chunk of at least 32 lanes does. A CTA takes as many row lanes as its range has rows, up to its
    share of 512 threads where the batch puts several CTAs on an SM, so
    that they all run in one wave. The plan depends on the shape alone,
    so the kernel's order of sums does too."""
    groups = -(-H // POOL_VEC)
    cc, r = -(-groups // POOL_MAX_LANES), 1
    while B * cc * r * 2 <= sms // 2 and cc * r * 2 <= POOL_SPREAD:
        if S // (r * 2) >= POOL_MIN_ROWS:
            r *= 2
        elif r == 1 and -(-groups // cc) >= 32:
            cc *= 2
        else:
            break
    lanes = -(-groups // cc)
    per_sm = -(-B * cc * r // sms)
    p = max(1, min(POOL_MAX_LANES // per_sm // lanes, -(-S // r)))
    return cc, r, lanes, p


def fused_mean_pool(hidden, mask, include_padding: bool = False
                    ) -> torch.Tensor:
    """K8: (B, S, H) bf16 or f32 hidden + (B, S) mask -> (B, H) f32 unit
    rows; the kernel for a CUDA tensor, mean_pool_plain for a CPU tensor.
    The kernel reads both in their own dtype: no cast runs here."""
    if not hidden.is_cuda:
        return mean_pool_plain(hidden, mask, include_padding)
    B, S, H = hidden.shape
    if hidden.dtype not in (torch.bfloat16, torch.float32) or \
            not hidden.is_contiguous():
        raise ValueError(f"K8 takes contiguous bf16 or f32 hidden states, "
                         f"got {hidden.dtype}"
                         f"{'' if hidden.is_contiguous() else ' (non-contiguous)'}")
    if H > POOL_MAX_H:
        raise ValueError(f"K8 spreads a row over at most {POOL_MAX_CLUSTER} "
                         f"CTAs of {POOL_MAX_LANES} threads, {POOL_VEC} "
                         f"columns each: H={H} is over {POOL_MAX_H}")
    mask_type, strides = 0, (0, 0)
    if not include_padding:
        if mask is None or tuple(mask.shape) != (B, S) or \
                mask.device != hidden.device:
            raise ValueError(f"K8 needs a (B, S) = {(B, S)} mask on "
                             f"{hidden.device}")
        if mask.dtype not in POOL_MASKS:
            raise ValueError(f"K8 reads a bool, int32, int64 or f32 mask, "
                             f"got {mask.dtype}")
        mask_type, strides = POOL_MASKS[mask.dtype], mask.stride()
    out = torch.empty((B, H), dtype=torch.float32, device=hidden.device)
    plan = plan_pool(B, S, H, torch.cuda.get_device_properties(
        hidden.device).multi_processor_count)
    _cuda.check(_cuda.lib().dawn_mean_pool(
        hidden.data_ptr(), None if include_padding else mask.data_ptr(),
        out.data_ptr(), B, S, H, int(hidden.dtype == torch.float32),
        mask_type, *strides, int(include_padding), *plan,
        _cuda.stream_handle(hidden)), "K8 pool")
    _cuda.count(launches, "kernel_mean_pool")
    return out


def _check_qkv(what: str, q, k, v, shape, S: int) -> None:
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or f32 on CUDA, got {q.dtype}")
    if S % 16 or S > MAX_SEQ:
        raise ValueError(f"{what} needs S % 16 == 0 and S <= {MAX_SEQ}; "
                         f"got S={S}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or tuple(t.shape) != tuple(shape) or \
                t.device != q.device or t.stride() != q.stride():
            raise ValueError(f"{what} {name} must match q: {q.dtype} "
                             f"{tuple(shape)} strides {q.stride()} on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()} on {t.device}")


def _attention_cuda(name: str, q, k, v, bias, out, B, nh, S, hd, strides,
                    out_strides) -> None:
    """Launch dawn_attention: the bf16 mma.sync kernel for bf16, the
    3xTF32 one (f32 in and out) for f32, never the fixed-order kernel
    (K4's); count under `name` or `name`_f32."""
    if bias is None:
        bias = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    _cuda.check_tensor(bias, "attention bias", torch.float32, (B, S), q.device)
    f32 = int(q.dtype == torch.float32)
    lib = _cuda.lib()
    # no rel operand: the reference bypasses K5 and K6 under MPNet's
    # position bias (models/bert.py::_attention)
    _cuda.check(lib.dawn_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), None,
        out.data_ptr(), B, nh, S, hd, *strides, *out_strides,
        1.0 / math.sqrt(hd), f32, f32, 0, _cuda.stream_handle(q)), name)
    _cuda.count(launches, name + ("_f32" if f32 else ""))
