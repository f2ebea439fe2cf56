"""Qwen3's forward and its sentence embedding in plain f32 torch.

Written from the equations of HF transformers' modeling_qwen3.py
(Qwen3Model; Zhang et al. 2025, "Qwen3 Embedding", arXiv 2506.05176), for
the checkpoint Qwen/Qwen3-Embedding-8B and any Qwen3Config without a
sliding window:

    x = E[ids]                                 no position embeddings
    layer i:
      a = RMS_in_i(x)
      q, k, v = a·Wq, a·Wk, a·Wv               nh, nkv, nkv heads of hd
      q, k = RoPE(RMS_q_i(q)), RoPE(RMS_k_i(k)) per-head norms over hd;
                                               rotate_half pairs (d, d + hd/2)
      s = q·kᵀ / √hd, keys j <= i              query head j on kv head
                                               j // (nh / nkv)
      h = x + softmax(s) · v · Wo
      m = RMS_post_i(h)
      x = h + (silu(m·Wg) ⊙ m·Wu) · Wd
    last = RMS_final(x)

Every RMSNorm is w ⊙ v / sqrt(mean(v²) + eps), in f32. The sentence
embedding (Qwen3-Embedding's model card) is `last` at the text's last
token, which the tokenizer makes <|endoftext|>, L2-normalised.

Each text runs alone, at positions 0 .. n − 1, with no padding. HF's
model card pads a batch on the left; that gives the same embedding,
because RoPE's scores depend only on the difference of two positions and
the causal mask with the padding mask leaves a row exactly its own
sequence's keys. Departures from HF's code: none in the equations; the
attention's mask is the causal one alone (no padding to mask), and
HF's additive mask of f32's most negative value becomes a -inf fill, the
same softmax.

Weights are a dict of HF tensor names with any `model.` prefix removed
(torch Linear layout, (out, in)).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rope_tables(S: int, hd: int, theta: float, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, hd) f32 cos and sin at positions 0..S-1: HF's default rotary
    init (inv_freq = 1 / θ^(2j / hd)) and forward (freqs = pos · inv_freq,
    duplicated over both halves)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64,
                                        device=device).float() / hd))
    pos = torch.arange(S, device=device).float()
    freqs = pos[:, None] * inv[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat((-x[..., h:], x[..., :h]), dim=-1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def head_dim(config: dict) -> int:
    return config.get("head_dim") or (config["hidden_size"]
                                      // config["num_attention_heads"])


def attention(q, k, v, rows: int | None = None) -> torch.Tensor:
    """(nh, S, hd) q and (nkv, S, hd) k, v -> (S, nh·hd): causal softmax
    attention, query head j on key/value head j // (nh / nkv), by blocks of
    `rows` query rows (all at once for None)."""
    nh, S, hd = q.shape
    group = nh // k.shape[0]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    out = torch.empty((S, nh * hd), device=q.device)
    step = rows or S
    for r0 in range(0, S, step):
        r1 = min(S, r0 + step)
        s = (q[:, r0:r1] @ k[:, :r1].transpose(-1, -2)) * hd ** -0.5
        i = torch.arange(r0, r1, device=q.device)[:, None]
        j = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(j > i, float("-inf"))
        ctx = torch.softmax(s, dim=-1) @ v[:, :r1]
        out[r0:r1] = ctx.transpose(0, 1).reshape(r1 - r0, nh * hd)
    return out


def layer(W: dict, config: dict, i: int, x: torch.Tensor,
          cos: torch.Tensor, sin: torch.Tensor,
          rows: int | None = None) -> torch.Tensor:
    """Layer i of Qwen3Model on one text's (S, H) f32 x."""
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd, eps, S = head_dim(config), config["rms_norm_eps"], x.shape[0]
    p = f"layers.{i}."
    a = rms_norm(x, W[p + "input_layernorm.weight"], eps)
    q = (a @ W[p + "self_attn.q_proj.weight"].T).view(S, nh, hd)
    k = (a @ W[p + "self_attn.k_proj.weight"].T).view(S, nkv, hd)
    v = (a @ W[p + "self_attn.v_proj.weight"].T).view(S, nkv, hd)
    q = rms_norm(q, W[p + "self_attn.q_norm.weight"], eps).transpose(0, 1)
    k = rms_norm(k, W[p + "self_attn.k_norm.weight"], eps).transpose(0, 1)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    ctx = attention(q, k, v.transpose(0, 1), rows)
    h = x + ctx @ W[p + "self_attn.o_proj.weight"].T
    m = rms_norm(h, W[p + "post_attention_layernorm.weight"], eps)
    g = torch.nn.functional.silu(m @ W[p + "mlp.gate_proj.weight"].T)
    u = m @ W[p + "mlp.up_proj.weight"].T
    return h + (g * u) @ W[p + "mlp.down_proj.weight"].T


@torch.no_grad()
def hidden_states(W: dict, config: dict, ids: torch.Tensor,
                  rows: int | None = None) -> torch.Tensor:
    """(S,) ids of one text -> (S, H) f32 last hidden state (after the
    final norm); the attention by blocks of `rows` query rows."""
    x = W["embed_tokens.weight"][ids].float()
    cos, sin = rope_tables(ids.shape[0], head_dim(config),
                           config["rope_theta"], ids.device)
    for i in range(config["num_hidden_layers"]):
        x = layer(W, config, i, x, cos, sin, rows)
    return rms_norm(x, W["norm.weight"], config["rms_norm_eps"])


@torch.no_grad()
def embed(W: dict, config: dict, ids_list: list[list[int]],
          device=None, rows: int | None = None) -> torch.Tensor:
    """Token id lists -> (N, H) f32 unit vectors: the last token's final
    hidden state, L2-normalised."""
    out = torch.empty((len(ids_list), config["hidden_size"]), device=device)
    for r, ids in enumerate(ids_list):
        h = hidden_states(W, config, torch.tensor(ids, device=device), rows)
        out[r] = torch.nn.functional.normalize(h[-1], dim=-1, eps=1e-12)
    return out
