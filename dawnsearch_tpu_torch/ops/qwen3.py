"""Qwen3's kernels (csrc/long/) and their plain twins.

A Qwen3 layer (models/qwen3.py) is pre-norm, bias-free and causal, with
grouped-query attention at head dim 128, per-head RMSNorms on q and k,
RoPE and a SwiGLU FFN. On the card, in bf16, it runs five launches of
csrc/long's kernels, with the residual stream x kept in f32 between them:

    qkv      = bf16(RoPE(RMS_h(r·a·Wqkv)·w_h))  long_gemm, EPI_QKN: the
                                                 input norm's row scale r,
                                                 each q and k head normed
                                                 over its 128 dims and
                                                 rotated (d, d + 64); v as
                                                 r·a·Wv
    ctx      = causal GQA attention             qwen3.cu: query head j on
                                                 key/value head j / (nh /
                                                 nkv)
    h, m, sq = x + ctx·Wo, bf16(h ⊙ w_post), Σh² long_gemm, EPI_RMS
    g        = bf16(silu(r·m·Wg) ⊙ r·m·Wu)       long_gemm, EPI_SWIGLU
    x', a', sq' = h + g·Wd, bf16(x' ⊙ w_in'), Σx'²  long_gemm, EPI_RMS

Every RMSNorm w ⊙ v / sqrt(mean(v²) + eps) is split in two: the launch
that forms v writes a = bf16(v ⊙ w) and the Σv² of each of its column
tiles (`ssq`, (M, parts) f32), and the GEMM that reads a scales its
accumulator's rows by r = 1 / sqrt(Σ parts / H + eps) (a·W is linear in
a's rows), so no launch needs a whole row of H = 4,096 at once. Before the
first layer one more launch gathers x = E[ids] (the table in bf16) with
layer 0's a and Σx² (`embed`), and after the last one the pool reads only
each sequence's last real row: the final RMSNorm, then L2, in f32
(`last_pool`; Qwen3-Embedding pools the last token).

On the card the SwiGLU's W_gu = [gate | up] (H, 2I) is held interleaved
(modernbert.interleave_gate): each 128-column tile holds 64 gate columns
and the same 64 up columns. The attention reads q, k and v as column
views of qkv and each sequence's real length (int32, (B,)); query rows at
or past it are zeros.

Every wrapper launches its kernel for a CUDA tensor and runs its plain
twin for a CPU tensor; a CUDA input outside a kernel's envelope raises.
The envelope: bf16 activations and matrices; head dim 128; nh / nkv in
{1, 2, 4, 8}; H % 256 == 0; N % 128 == 0 for every GEMM; at most 16 parts
a row (H <= 4,096 at 256 columns a part); S % 16 == 0, S <= 8192. The
twins compute in f32 from operands in the compute dtype and round where
the kernels round, but keep p in f32.
"""

from __future__ import annotations

import math

import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops._cuda import check_tensor
from dawnsearch_tpu_torch.ops.modernbert import rope_plain

# CUDA launches in this process, by METRICS name (_cuda.count)
launches = {f"kernel_qwen3_{k}": 0 for k in (
    "embed", "qkv_norm_rope", "attention", "resid_rms", "swiglu",
    "last_pool")}

MAX_SEQ = 8192
HEAD_DIM = 128
MAX_PARTS = 16
EPI_QKN, EPI_SWIGLU, EPI_RMS = 4, 5, 6
_EPI_NAMES = {EPI_QKN: "qwen3 QKV projection + norms + RoPE",
              EPI_SWIGLU: "qwen3 SwiGLU projection",
              EPI_RMS: "qwen3 projection + residual + RMS parts"}


def parts(n: int) -> int:
    """Column tiles (Σv² parts a row) of EPI_RMS's output of width n: the
    ring's 256-column tiles where n % 256 == 0, else 128."""
    return n // 256 if n % 256 == 0 else n // 128


def row_scale(ssq: torch.Tensor, n: int, eps: float) -> torch.Tensor:
    """(M, parts) Σv² -> (M, 1) f32 r = 1 / sqrt(Σ / n + eps)."""
    return torch.rsqrt(ssq.sum(dim=1, keepdim=True) / n + eps)


def rms_head(t: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of an f32 t: w ⊙ t / sqrt(mean(t²) + eps)."""
    return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + eps) * w


# -- plain twins ------------------------------------------------------------

def embed_plain(table, ids, w, dt) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    x = table[ids.reshape(-1)].float()
    return x, (x * w).to(dt), (x * x).sum(1, keepdim=True)


def qkv_norm_rope_plain(a, ssq, w, qn, kn, cos, sin, S: int, nh: int,
                        nkv: int, eps: float) -> torch.Tensor:
    M, N = a.shape[0], w.shape[1]
    y = (a.float() @ w.float()) * row_scale(ssq, a.shape[1], eps)
    y = y.view(M // S, S, N // HEAD_DIM, HEAD_DIM)
    q = rms_head(y[:, :, :nh], qn, eps)
    k = rms_head(y[:, :, nh:nh + nkv], kn, eps)
    qk = rope_plain(torch.cat((q, k), dim=2), cos[:S], sin[:S])
    return torch.cat((qk, y[:, :, nh + nkv:]), dim=2).reshape(M, N).to(
        a.dtype)


def attention_plain(qkv, lengths, B: int, S: int, nh: int, nkv: int
                    ) -> torch.Tensor:
    hd = HEAD_DIM
    t = qkv.float().view(B, S, nh + 2 * nkv, hd).transpose(1, 2)
    q, k, v = t[:, :nh], t[:, nh:nh + nkv], t[:, nh + nkv:]
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    i = torch.arange(S, device=qkv.device)
    lens = lengths.to(qkv.device).long()
    keep = (i[None, :, None] >= i[None, None, :]) & \
        (i[None, None, :] < lens[:, None, None])
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~keep[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    ctx = (p @ v).transpose(1, 2).reshape(B, S, nh * hd)
    live = (i[None, :] < lens[:, None])[..., None]
    return torch.where(live, ctx, 0.0).reshape(B * S, nh * hd).to(qkv.dtype)


def resid_rms_plain(a, w, resid, s) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    h = resid + a.float() @ w.float()
    n = h.shape[1]
    sq = (h * h).view(h.shape[0], parts(n), -1).sum(-1)
    return h, (h * s).to(a.dtype), sq


def swiglu_plain(a, ssq, w, eps: float) -> torch.Tensor:
    """The twin takes W_gu as [gate | up], (H, 2I)."""
    y = (a.float() @ w.float()) * row_scale(ssq, a.shape[1], eps)
    g, u = y.chunk(2, dim=-1)
    return (torch.nn.functional.silu(g) * u).to(a.dtype)


def last_pool_plain(x, lengths, S: int, w, eps: float) -> torch.Tensor:
    B = x.shape[0] // S
    last = lengths.to(x.device).long().clamp(1, S) - 1
    rows = x.view(B, S, -1)[torch.arange(B, device=x.device), last]
    y = rms_head(rows, w, eps)
    return torch.nn.functional.normalize(y, dim=-1, eps=1e-12)


# -- wrappers ---------------------------------------------------------------

def embed(table, ids, w, dt) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(B, S) ids -> (x (B·S, H) f32 = table[ids], a = x ⊙ w in dt, ssq
    (B·S, 1) f32 = Σx²)."""
    if not table.is_cuda:
        return embed_plain(table, ids, w, dt)
    if dt != torch.bfloat16:
        raise ValueError(f"qwen3 embed writes bf16 a, not {dt}")
    V, H = table.shape
    M = ids.numel()
    dev = table.device
    if H % 256:
        raise ValueError(f"qwen3 embed takes H % 256 == 0; got H={H}")
    check_tensor(table, "qwen3 embed table", torch.bfloat16, (V, H), dev)
    check_tensor(ids, "qwen3 embed ids", torch.int64, ids.shape, dev)
    check_tensor(w, "qwen3 embed norm weight", torch.float32, (H,), dev)
    x = torch.empty((M, H), dtype=torch.float32, device=dev)
    a = torch.empty((M, H), dtype=torch.bfloat16, device=dev)
    ssq = torch.empty((M, 1), dtype=torch.float32, device=dev)
    _cuda.check(_cuda.long_lib().dawn_qwen3_embed(
        ids.data_ptr(), table.data_ptr(), w.data_ptr(), x.data_ptr(),
        a.data_ptr(), ssq.data_ptr(), M, H, V, _cuda.stream_handle(table)),
        "qwen3 embed")
    _cuda.count(launches, "kernel_qwen3_embed")
    return x, a, ssq


def _gemm(epi: int, a, w, *, out, out2=None, resid=None, s=None, cos=None,
          sin=None, ssq_in=None, ssq_out=None, qn=None, kn=None, S: int = 0,
          q_cols: int = 0, rope_cols: int = 0, eps: float = 0.0) -> None:
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
    rparts = 0
    if ssq_in is not None:
        rparts = ssq_in.shape[1]
        if not 1 <= rparts <= MAX_PARTS:
            raise ValueError(f"{what} sums at most {MAX_PARTS} Σv² parts a "
                             f"row; got {rparts}")
        check_tensor(ssq_in, f"{what} ssq", torch.float32, (M, rparts), dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _cuda.check(_cuda.long_lib().dawn_qwen3_gemm(
        a.data_ptr(), w.data_ptr(), epi, out.data_ptr(), ptr(out2),
        ptr(resid), ptr(s), ptr(cos), ptr(sin), ptr(ssq_in), ptr(ssq_out),
        ptr(qn), ptr(kn), rparts, M, N, K, S, q_cols, rope_cols, eps,
        _cuda.stream_handle(a)), what)


def qkv_norm_rope(a, ssq, w, qn, kn, cos, sin, S: int, nh: int, nkv: int,
                  eps: float) -> torch.Tensor:
    """(M, H) a (= bf16(x ⊙ w_in)) with x's Σx² parts · the (H, (nh + 2nkv)
    ·128) Wqkv -> qkv in a's dtype: rows scaled by r, q's nh and k's nkv
    heads RMS-normed with qn / kn (128,) and rotated by position (row % S)
    with the (>= S, 64) cos and sin tables."""
    if not a.is_cuda:
        return qkv_norm_rope_plain(a, ssq, w, qn, kn, cos, sin, S, nh, nkv,
                                   eps)
    M, N = a.shape[0], w.shape[1]
    if N != (nh + 2 * nkv) * HEAD_DIM or M % S or cos.shape[0] < S:
        raise ValueError(f"qwen3 QKV: N = (nh + 2·nkv)·{HEAD_DIM}, M a "
                         f"multiple of S, tables of >= S rows; got N={N}, "
                         f"nh={nh}, nkv={nkv}, M={M}, S={S}, tables "
                         f"{tuple(cos.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        check_tensor(t, f"qwen3 QKV {name}", torch.float32,
                     (cos.shape[0], HEAD_DIM // 2), a.device)
    for name, t in (("q_norm", qn), ("k_norm", kn)):
        check_tensor(t, f"qwen3 QKV {name}", torch.float32, (HEAD_DIM,),
                     a.device)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _gemm(EPI_QKN, a, w, out=out, cos=cos, sin=sin, ssq_in=ssq, qn=qn, kn=kn,
          S=S, q_cols=nh * HEAD_DIM, rope_cols=(nh + nkv) * HEAD_DIM,
          eps=eps)
    _cuda.count(launches, "kernel_qwen3_qkv_norm_rope")
    return out


def resid_rms(a, w, resid, s) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(M, K) a · the (K, H) w + the f32 (M, H) resid -> (h f32, bf16(h ⊙
    s), (M, parts(H)) f32 Σh² of each column tile)."""
    if not a.is_cuda:
        return resid_rms_plain(a, w, resid, s)
    M, H = a.shape[0], w.shape[1]
    check_tensor(resid, "qwen3 projection + RMS resid", torch.float32,
                 (M, H), a.device)
    check_tensor(s, "qwen3 projection + RMS weight", torch.float32, (H,),
                 a.device)
    h = torch.empty((M, H), dtype=torch.float32, device=a.device)
    y = torch.empty((M, H), dtype=a.dtype, device=a.device)
    sq = torch.empty((M, parts(H)), dtype=torch.float32, device=a.device)
    _gemm(EPI_RMS, a, w, out=h, out2=y, resid=resid, s=s, ssq_out=sq)
    _cuda.count(launches, "kernel_qwen3_resid_rms")
    return h, y, sq


def swiglu(a, ssq, w, eps: float) -> torch.Tensor:
    """(M, H) a (= bf16(h ⊙ w_post)) with h's Σh² parts · W_gu -> (M, I)
    silu(r·a·Wg) ⊙ r·a·Wu in a's dtype. On the card W_gu is the
    interleaved (H, 2I); the twin takes [gate | up]."""
    if not a.is_cuda:
        return swiglu_plain(a, ssq, w, eps)
    out = torch.empty((a.shape[0], w.shape[1] // 2), dtype=a.dtype,
                      device=a.device)
    _gemm(EPI_SWIGLU, a, w, out=out, ssq_in=ssq, eps=eps)
    _cuda.count(launches, "kernel_qwen3_swiglu")
    return out


def attention(qkv, lengths, B: int, S: int, nh: int, nkv: int
              ) -> torch.Tensor:
    """(B·S, (nh + 2nkv)·128) qkv and (B,) int32 real lengths -> (B·S,
    nh·128) causal context in qkv's dtype, query head j on key/value head
    j / (nh / nkv)."""
    if not qkv.is_cuda:
        return attention_plain(qkv, lengths, B, S, nh, nkv)
    N = (nh + 2 * nkv) * HEAD_DIM
    check_tensor(qkv, "qwen3 attention qkv", torch.bfloat16, (B * S, N),
                 qkv.device)
    check_tensor(lengths, "qwen3 attention lengths", torch.int32, (B,),
                 qkv.device)
    if nkv <= 0 or nh % nkv or nh // nkv not in (1, 2, 4, 8) or S % 16 or \
            S > MAX_SEQ or B > 65535:
        raise ValueError(f"qwen3 attention takes nh / nkv in (1, 2, 4, 8), "
                         f"S % 16 == 0, S <= {MAX_SEQ}; got nh={nh}, "
                         f"nkv={nkv}, S={S}, B={B}")
    out = torch.empty((B * S, nh * HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    _cuda.check(_cuda.long_lib().dawn_qwen3_attention(
        qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, S, nh, nkv,
        1.0 / math.sqrt(HEAD_DIM), _cuda.stream_handle(qkv)),
        "qwen3 attention")
    _cuda.count(launches, "kernel_qwen3_attention")
    return out


def last_pool(x, lengths, S: int, w, eps: float) -> torch.Tensor:
    """(B·S, H) f32 x and (B,) int32 lengths -> (B, H) f32 unit vectors:
    each sequence's last real row, RMS-normed with w, L2-normalised."""
    if not x.is_cuda:
        return last_pool_plain(x, lengths, S, w, eps)
    M, H = x.shape
    B = M // S
    check_tensor(x, "qwen3 pool x", torch.float32, (B * S, H), x.device)
    check_tensor(lengths, "qwen3 pool lengths", torch.int32, (B,), x.device)
    check_tensor(w, "qwen3 pool weight", torch.float32, (H,), x.device)
    out = torch.empty((B, H), dtype=torch.float32, device=x.device)
    _cuda.check(_cuda.long_lib().dawn_qwen3_last_pool(
        x.data_ptr(), lengths.data_ptr(), w.data_ptr(), out.data_ptr(), B, S,
        H, eps, _cuda.stream_handle(x)), "qwen3 pool")
    _cuda.count(launches, "kernel_qwen3_last_pool")
    return out
