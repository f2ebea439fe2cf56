"""ModernBERT's forward and its sentence embedding in plain f32 torch.

Written from the equations of HF transformers' modeling_modernbert.py
(Warner et al. 2024, arXiv 2412.13663), for the checkpoint
nomic-ai/modernbert-embed-base and any ModernBertConfig:

    x = LN_emb(E[ids])                         no position embeddings
    layer i:
      a = LNa_i(x)                             LNa_0 is the identity
      q, k, v = split(a · Wqkv)                heads of hd = H / nh
      q, k = RoPE_θi(q), RoPE_θi(k)            rotate_half pairs (d, d + hd/2)
      s = q·kᵀ / √hd + mask                    mask: padding keys; in a local
                                               layer also |i − j| > window / 2
      h = x + softmax(s) · v · Wo
      (g_in, g_gate) = chunk(LNm_i(h) · Wi, 2)
      x = h + (gelu(g_in) ⊙ g_gate) · Wo2      gelu with the exact erf
    last = LN_final(x)

Layer i is global when i % global_attn_every_n_layers == 0 (θ =
global_rope_theta), else local (θ = local_rope_theta, window
local_attention). Every LayerNorm has a scale and, with norm_bias false,
no bias; the linears have no bias when attention_bias / mlp_bias are
false. The sentence embedding is the masked mean of `last` over the real
tokens, L2-normalised (sentence-transformers' mean pooling).

Departures from HF's code: HF's unpadded flash-attention path is not
followed: the padded eager path is, with the padding and the window as
additive masks of f32's most negative finite value, as HF builds them
(a padding row that sees no key in its window then stays finite).
Nothing else.

Weights are a dict of HF tensor names with any `model.` prefix removed
(torch Linear layout, (out, in)).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def is_global(config: dict, i: int) -> bool:
    return i % config["global_attn_every_n_layers"] == 0


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


def _ln(x, w, eps):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, None, eps)


def _lin(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def attention_mask(mask: torch.Tensor, window: int | None) -> torch.Tensor:
    """(B, S) 0/1 mask -> (B, 1, S, S) additive f32 mask: f32's most
    negative finite value at padding keys and, with a window, at keys
    farther than window // 2 from the query."""
    B, S = mask.shape
    keep = mask.bool()[:, None, None, :].expand(B, 1, S, S)
    if window is not None:
        i = torch.arange(S, device=mask.device)
        near = (i[:, None] - i[None, :]).abs() <= window // 2
        keep = keep & near[None, None]
    return torch.where(keep, 0.0, torch.finfo(torch.float32).min)


@torch.no_grad()
def hidden_states(weights: dict, config: dict, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(B, S) ids and 0/1 mask -> (B, S, H) f32 last hidden state (after
    final_norm)."""
    W = {k[len("model."):] if k.startswith("model.") else k: v
         for k, v in weights.items()}
    H, nh = config["hidden_size"], config["num_attention_heads"]
    hd = H // nh
    eps = config["norm_eps"]
    B, S = ids.shape
    dev = ids.device
    x = _ln(W["embeddings.tok_embeddings.weight"][ids],
            W["embeddings.norm.weight"], eps)
    tables = {False: rope_tables(S, hd, config["local_rope_theta"], dev),
              True: rope_tables(S, hd, config["global_rope_theta"], dev)}
    masks = {False: attention_mask(mask, config["local_attention"]),
             True: attention_mask(mask, None)}
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        glob = is_global(config, i)
        a = x if i == 0 else _ln(x, W[p + "attn_norm.weight"], eps)
        qkv = _lin(a, W[p + "attn.Wqkv.weight"], W.get(p + "attn.Wqkv.bias"))
        q, k, v = (t.view(B, S, nh, hd).transpose(1, 2)
                   for t in qkv.split(H, dim=-1))
        cos, sin = tables[glob]
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + masks[glob]
        ctx = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, S, H)
        h = x + _lin(ctx, W[p + "attn.Wo.weight"], W.get(p + "attn.Wo.bias"))
        m = _lin(_ln(h, W[p + "mlp_norm.weight"], eps),
                 W[p + "mlp.Wi.weight"], W.get(p + "mlp.Wi.bias"))
        g_in, g_gate = m.chunk(2, dim=-1)
        x = h + _lin(torch.nn.functional.gelu(g_in) * g_gate,
                     W[p + "mlp.Wo.weight"], W.get(p + "mlp.Wo.bias"))
    return _ln(x, W["final_norm.weight"], eps)


@torch.no_grad()
def embed(weights: dict, config: dict, ids: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    """(B, S) ids and mask -> (B, H) f32 unit vectors: the masked mean of
    the last hidden state over the real tokens, L2-normalised."""
    h = hidden_states(weights, config, ids, mask)
    m = mask[..., None].float()
    pooled = (h * m).sum(1) / m.sum(1)
    return torch.nn.functional.normalize(pooled, dim=-1, eps=1e-12)
