"""ModernBERT's long-context kernels (csrc/long/) and their plain twins.

A ModernBERT layer (models/modernbert.py) is pre-norm, bias-free, with
rotary positions, windowed or global attention and a GeGLU FFN. On the
card, in bf16, it runs four launches of csrc/long's kernels, with the
residual stream x kept in f32 between them:

    qkv    = bf16(RoPE_θ(a·Wqkv))            long_gemm, EPI_ROPE: the
                                              rotation of q's and k's head
                                              dims (d, d + hd/2) in the
                                              epilogue, f32, rounded once
    ctx    = bf16(softmax(q·kᵀ/√hd + mask)·v) long_attention: global, or
                                              windowed (|i − j| <= window)
    h, m   = x + ctx·Wo, bf16(LN(h)·s)        long_gemm, EPI_LN: the
                                              residual add and the next
                                              norm over a cluster of H/128
    g      = bf16(gelu(m·Wi_a) ⊙ m·Wi_g)      long_gemm, EPI_GEGLU
    x', a' = h + g·Wo2, LN(x')·s'             long_gemm, EPI_LN (a' in f32
                                              after the last layer: the
                                              final norm, which K8 pools)

and one more before the first layer: x = LN(E[ids])·s, a = bf16(x)
(long_embed_ln; ModernBERT's first attn_norm is the identity). Every
LayerNorm has a scale and no bias, in f32.

On the card the GeGLU's Wi is held interleaved (`interleave_gate`): each
128-column tile holds 64 columns of the GELU half and the same 64 of the gate half,
so one CTA's epilogue pairs them in registers. The attention reads q, k
and v as column views of qkv (row stride 3H) and each sequence's real
length (int32, (B,)): keys at or past a sequence's length are masked,
key tiles wholly past it are skipped, and query rows at or past it are
written as zeros (their values reach no real row: every later step is
row-wise, and their keys are masked). Softmax runs online in f32 with p
rounded to bf16 for PV, in one of two kernels chosen by the window (the
notes are in csrc/long/attention_long.cu). The global one is FLOP bound
and built for Hopper: a CTA owns 128 query rows of one (sequence, head),
a producer warp streams 128-key K and V tiles by TMA into a two-stage
ring, and two consumer warpgroups compute QKᵀ and PV with wgmma (P from
registers), one's softmax running while the other's products do; the
rows of the last tile past the length are masked (scores) and zeroed (V),
so whatever they hold contributes nothing. The windowed one is bytes
bound and keeps the mma.sync design over 64-key tiles: it visits only the
key tiles that meet the band, so its cost follows the window, not S.

Every wrapper launches its kernel for a CUDA tensor and runs its plain
twin for a CPU tensor; a CUDA input outside a kernel's envelope raises.
The envelope: bf16 activations and matrices; H % 128 == 0, H <= 2048;
hd = 64; N % 128 == 0 for every GEMM; S % 16 == 0, S <= 8192. The twins
compute in f32 from operands in the compute dtype (the matrices' dtype)
and round where the kernels round, but keep p in f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops._cuda import MAX_LN_WIDTH, check_tensor
from dawnsearch_tpu_torch.ops.ffn import erf_poly
from dawnsearch_tpu_torch.ops.vector import layer_norm

# CUDA launches in this process, by METRICS name (_cuda.count)
launches = {f"kernel_long_{k}": 0 for k in (
    "embed", "qkv_rope", "attention_global", "attention_local", "gemm_ln",
    "geglu")}

MAX_SEQ = 8192
HEAD_DIM = 64
EPI_ROPE, EPI_GEGLU, EPI_LN, EPI_LN_F32 = 0, 1, 2, 3
_EPI_NAMES = ("long QKV projection + RoPE", "long GeGLU projection",
              "long projection + residual + LN",
              "long projection + residual + final LN")


# -- the model's fixed tensors -------------------------------------------

def rope_tables(S: int, hd: int, theta: float, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, hd / 2) f32 cos and sin at positions 0..S-1, as HF's default
    rotary embedding computes them: inv_freq = 1 / θ^(2j / hd), the angle
    pos · inv_freq (both halves of a head share it)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64,
                                        device=device).float() / hd))
    ang = torch.arange(S, device=device).float()[:, None] * inv[None, :]
    return ang.cos().contiguous(), ang.sin().contiguous()


def interleave_gate(w: torch.Tensor) -> torch.Tensor:
    """(H, 2I) Wi, GELU half then gate half -> (H, 2I) with each 128
    columns [64 of the GELU half | the same 64 of the gate half]; I % 64
    == 0."""
    H, n = w.shape
    if n % 128:
        raise ValueError(f"Wi's width 2I = {n} is not a multiple of 128")
    return w.view(H, 2, n // 128, 64).transpose(1, 2).reshape(H, n)


def band_keys(n: int, window: int | None) -> int:
    """Keys that the n real query rows of a sequence of length n attend
    to: n² for global attention, Σ_i |[i − w, i + w] ∩ [0, n)| for a
    window w."""
    if window is None:
        return n * n
    i = np.arange(n)
    return int((np.minimum(i + window, n - 1) - np.maximum(i - window, 0)
                + 1).sum())


def scale_ln(y: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
    """ModernBERT's LayerNorm of an f32 y: a scale, no bias, in f32."""
    return layer_norm(y, s, torch.zeros_like(s), eps)


def rope_plain(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """(B, S, n, hd) f32 heads rotated: (x_d, x_{d+hd/2}) -> (x_d·c −
    x_{d+hd/2}·s, x_{d+hd/2}·c + x_d·s), c and s of (S, hd/2)."""
    h = t.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    lo, hi = t[..., :h], t[..., h:]
    return torch.cat((lo * c - hi * s, hi * c + lo * s), dim=-1)


# -- plain twins ------------------------------------------------------------

def embed_ln_plain(table, ids, ln_s, eps: float, dt
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    x = scale_ln(table[ids.reshape(-1)].float(), ln_s, eps)
    return x, x.to(dt)


def qkv_rope_plain(a, w, cos, sin, S: int, nh: int) -> torch.Tensor:
    M, H3 = a.shape[0], w.shape[1]
    hd = H3 // 3 // nh
    y = (a.float() @ w.float()).view(M // S, S, 3, nh, hd)
    qk = rope_plain(y[:, :, :2].reshape(M // S, S, 2 * nh, hd),
                    cos[:S], sin[:S]).view(M // S, S, 2, nh, hd)
    return torch.cat((qk, y[:, :, 2:]), dim=2).reshape(M, H3).to(a.dtype)


def attention_plain(qkv, lengths, B: int, S: int, nh: int,
                    window: int | None) -> torch.Tensor:
    H = qkv.shape[1] // 3
    hd = H // nh
    q, k, v = (t.float().reshape(B, S, nh, hd).transpose(1, 2)
               for t in qkv.view(B * S, 3 * H).split(H, dim=1))
    i = torch.arange(S, device=qkv.device)
    lens = lengths.to(qkv.device).long()
    keep = (i[None, None, :] < lens[:, None, None]).expand(B, S, S)
    if window is not None:
        keep = keep & ((i[:, None] - i[None, :]).abs() <= window)[None]
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~keep[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    ctx = (p @ v).transpose(1, 2).reshape(B, S, H)
    live = (i[None, :] < lens[:, None])[..., None]
    return torch.where(live, ctx, 0.0).reshape(B * S, H).to(qkv.dtype)


def resid_ln_plain(a, w, resid, ln_s, eps: float, out_dtype
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    h = resid + a.float() @ w.float()
    return h, scale_ln(h, ln_s, eps).to(out_dtype)


def geglu_plain(a, w) -> torch.Tensor:
    """The twin takes Wi as published, (H, 2I): GELU half, gate half."""
    g_in, g_gate = (a.float() @ w.float()).chunk(2, dim=-1)
    gelu = 0.5 * g_in * (1.0 + erf_poly(g_in * 2.0 ** -0.5))
    return (gelu * g_gate).to(a.dtype)


# -- wrappers ---------------------------------------------------------------

def _check_rows(what: str, H: int) -> None:
    if H % 128 or H > MAX_LN_WIDTH:
        raise ValueError(f"{what} takes H % 128 == 0 and H <= "
                         f"{MAX_LN_WIDTH}; got H={H}")


def embed_ln(table, ids, ln_s, eps: float, dt
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) ids -> (x (B·S, H) f32 = LN(table[ids])·ln_s, a = x in dt)."""
    if not table.is_cuda:
        return embed_ln_plain(table, ids, ln_s, eps, dt)
    V, H = table.shape
    M = ids.numel()
    _check_rows("long_embed_ln", H)
    check_tensor(table, "long_embed_ln table", torch.float32, (V, H),
                 table.device)
    check_tensor(ids, "long_embed_ln ids", torch.int64, ids.shape,
                 table.device)
    check_tensor(ln_s, "long_embed_ln scale", torch.float32, (H,),
                 table.device)
    if dt != torch.bfloat16:
        raise ValueError(f"long_embed_ln writes bf16 a, not {dt}")
    x = torch.empty((M, H), dtype=torch.float32, device=table.device)
    a = torch.empty((M, H), dtype=dt, device=table.device)
    _cuda.check(_cuda.long_lib().dawn_long_embed_ln(
        ids.data_ptr(), table.data_ptr(), ln_s.data_ptr(), x.data_ptr(),
        a.data_ptr(), M, H, V, eps, _cuda.stream_handle(table)),
        "long_embed_ln")
    _cuda.count(launches, "kernel_long_embed")
    return x, a


def _gemm(epi: int, a, w, *, out, out2=None, resid=None, ln_s=None,
          cos=None, sin=None, S: int = 0, eps: float = 0.0) -> None:
    M, K = a.shape
    N = w.shape[1]
    dev = a.device
    what = _EPI_NAMES[epi]
    check_tensor(a, f"{what} a", torch.bfloat16, (M, K), dev)
    check_tensor(w, f"{what} w", torch.bfloat16, (K, N), dev)
    if K % 64 or N % 128:
        raise ValueError(f"{what} takes K % 64 == 0 and N % 128 == 0; got "
                         f"K={K}, N={N}")
    if any(t.data_ptr() % 16 for t in (a, w)):
        raise ValueError(f"{what} reads a and w by TMA: 16-byte aligned")

    def ptr(t):
        return None if t is None else t.data_ptr()
    _cuda.check(_cuda.long_lib().dawn_long_gemm(
        a.data_ptr(), w.data_ptr(), epi, out.data_ptr(), ptr(out2),
        ptr(resid), ptr(ln_s), ptr(cos), ptr(sin), M, N, K, S, HEAD_DIM, eps,
        _cuda.stream_handle(a)), what)


def qkv_rope(a, w, cos, sin, S: int, nh: int) -> torch.Tensor:
    """(M, H) a · the (H, 3H) Wqkv -> (M, 3H) qkv in a's dtype, q's and
    k's nh heads rotated by position (row % S) with the (≥ S, hd / 2) cos
    and sin tables."""
    if not a.is_cuda:
        return qkv_rope_plain(a, w, cos, sin, S, nh)
    M, H3 = a.shape[0], w.shape[1]
    if H3 != 3 * nh * HEAD_DIM or M % S or cos.shape[0] < S:
        raise ValueError(f"long QKV + RoPE: N = 3H with hd {HEAD_DIM}, M a "
                         f"multiple of S, tables of >= S rows; got N={H3}, "
                         f"M={M}, S={S}, tables {tuple(cos.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        check_tensor(t, f"long QKV + RoPE {name}", torch.float32,
                     (cos.shape[0], HEAD_DIM // 2), a.device)
    out = torch.empty((M, H3), dtype=a.dtype, device=a.device)
    _gemm(EPI_ROPE, a, w, out=out, cos=cos, sin=sin, S=S)
    _cuda.count(launches, "kernel_long_qkv_rope")
    return out


def resid_ln(a, w, resid, ln_s, eps: float, out_dtype
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, K) a · the (K, H) w + the f32 (M, H) resid -> (h f32,
    LN(h)·ln_s in out_dtype: bf16, or f32 for the final norm)."""
    if not a.is_cuda:
        return resid_ln_plain(a, w, resid, ln_s, eps, out_dtype)
    M, H = a.shape[0], w.shape[1]
    _check_rows("long projection + LN", H)
    check_tensor(resid, "long projection + LN resid", torch.float32, (M, H),
                 a.device)
    check_tensor(ln_s, "long projection + LN scale", torch.float32, (H,),
                 a.device)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"long projection + LN writes bf16 or f32, not "
                         f"{out_dtype}")
    h = torch.empty((M, H), dtype=torch.float32, device=a.device)
    y = torch.empty((M, H), dtype=out_dtype, device=a.device)
    epi = EPI_LN_F32 if out_dtype == torch.float32 else EPI_LN
    _gemm(epi, a, w, out=h, out2=y, resid=resid, ln_s=ln_s, eps=eps)
    _cuda.count(launches, "kernel_long_gemm_ln")
    return h, y


def geglu(a, w) -> torch.Tensor:
    """(M, H) a · Wi -> (M, I) gelu(a·Wi_a) ⊙ a·Wi_g in a's dtype (GELU
    with the A&S erf polynomial). On the card Wi is the interleaved (H,
    2I) of `interleave_gate`; the twin takes it as published."""
    if not a.is_cuda:
        return geglu_plain(a, w)
    out = torch.empty((a.shape[0], w.shape[1] // 2), dtype=a.dtype,
                      device=a.device)
    _gemm(EPI_GEGLU, a, w, out=out)
    _cuda.count(launches, "kernel_long_geglu")
    return out


def attention(qkv, lengths, B: int, S: int, nh: int,
              window: int | None) -> torch.Tensor:
    """(B·S, 3H) qkv (q, k, v column blocks, heads of 64) and (B,) int32
    real lengths -> (B·S, H) context in qkv's dtype: global attention for
    window None, else keys within `window` positions of the query."""
    if not qkv.is_cuda:
        return attention_plain(qkv, lengths, B, S, nh, window)
    H = nh * HEAD_DIM
    if qkv.shape[1] != 3 * H:
        raise ValueError(f"long attention takes heads of {HEAD_DIM}: qkv "
                         f"is (B·S, {3 * H}) at nh={nh}, got "
                         f"{tuple(qkv.shape)}")
    check_tensor(qkv, "long attention qkv", torch.bfloat16, (B * S, 3 * H),
                 qkv.device)
    check_tensor(lengths, "long attention lengths", torch.int32, (B,),
                 qkv.device)
    if S % 16 or S > MAX_SEQ or B > 65535 or nh > 65535 or \
            (window is not None and window < 0):
        raise ValueError(f"long attention takes S % 16 == 0, S <= "
                         f"{MAX_SEQ}, a window >= 0; got S={S}, "
                         f"window={window}")
    out = torch.empty((B * S, H), dtype=qkv.dtype, device=qkv.device)
    _cuda.check(_cuda.long_lib().dawn_long_attention(
        qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, S, nh,
        HEAD_DIM, -1 if window is None else window,
        1.0 / math.sqrt(HEAD_DIM), _cuda.stream_handle(qkv)),
        "long attention")
    _cuda.count(launches, "kernel_long_attention_"
                + ("global" if window is None else "local"))
    return out
