"""ModernBERT's sentence encoder in plain torch, f32, TF32 off: the
equations of reference/modernbert_plain.py at the checkout's root
(HF transformers' modeling_modernbert.py), computed a text at a time and
the attention in blocks of query rows, so that a text of 8,192 tokens
fits: a global layer's scores are (nh, rows, S), a local layer's only the
keys within local_attention // 2 positions of the block.

    x = LN(E[ids]); each layer: h = x + Wo·attn(RoPE(Wqkv·LNa(x)))
    (LNa_0 the identity), x = h + Wo2·(gelu(a) ⊙ g), (a, g) = chunk(Wi·
    LNm(h)); then LN_final, the mean over the tokens, L2-normalised.

Every LayerNorm has a scale only; layers i % global_attn_every_n_layers
== 0 attend globally with global_rope_theta, the others locally with
local_rope_theta. Weights are HF ModernBertModel tensor names, bare.
"""

from __future__ import annotations

import torch

from benchmark.reference.encoder import strict_f32

ROWS = 1024  # query rows an attention block


def _rope(S: int, hd: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64,
                                        device=device).float() / hd))
    ang = torch.arange(S, device=device).float()[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., h:], x[..., :h]), dim=-1) * sin


def _ln(x, w, eps):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, None, eps)


def _attend(q, k, v, window: int | None) -> torch.Tensor:
    """(nh, S, hd) q, k, v -> (S, nh·hd): softmax(q·kᵀ/√hd) v, keys within
    `window` of the query where a window is given, by blocks of rows."""
    nh, S, hd = q.shape
    out = torch.empty((S, nh * hd), device=q.device)
    for r0 in range(0, S, ROWS):
        r1 = min(S, r0 + ROWS)
        k0, k1 = (0, S) if window is None else (max(0, r0 - window),
                                                 min(S, r1 + window))
        s = (q[:, r0:r1] @ k[:, k0:k1].transpose(-1, -2)) * hd ** -0.5
        if window is not None:
            i = torch.arange(r0, r1, device=q.device)[:, None]
            j = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill((i - j).abs() > window, float("-inf"))
        ctx = torch.softmax(s, dim=-1) @ v[:, k0:k1]
        out[r0:r1] = ctx.transpose(0, 1).reshape(r1 - r0, nh * hd)
    return out


@torch.no_grad()
def hidden_states(W: dict, config: dict, ids: torch.Tensor) -> torch.Tensor:
    """(S,) ids of one text -> (S, H) f32 last hidden state."""
    H, nh = config["hidden_size"], config["num_attention_heads"]
    hd, eps, S = H // nh, config["norm_eps"], ids.shape[0]
    dev = ids.device
    x = _ln(W["embeddings.tok_embeddings.weight"][ids],
            W["embeddings.norm.weight"], eps)
    tables = {True: _rope(S, hd, config["global_rope_theta"], dev),
              False: _rope(S, hd, config["local_rope_theta"], dev)}
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        glob = i % config["global_attn_every_n_layers"] == 0
        a = x if i == 0 else _ln(x, W[p + "attn_norm.weight"], eps)
        q, k, v = (t.view(S, nh, hd).transpose(0, 1)
                   for t in (a @ W[p + "attn.Wqkv.weight"].T).split(H, -1))
        cos, sin = tables[glob]
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        ctx = _attend(q, k, v, None if glob
                      else config["local_attention"] // 2)
        h = x + ctx @ W[p + "attn.Wo.weight"].T
        g_in, g_gate = (_ln(h, W[p + "mlp_norm.weight"], eps)
                        @ W[p + "mlp.Wi.weight"].T).chunk(2, dim=-1)
        x = h + (torch.nn.functional.gelu(g_in) * g_gate) \
            @ W[p + "mlp.Wo.weight"].T
    return _ln(x, W["final_norm.weight"], eps)


@torch.no_grad()
def embed(W: dict, config: dict, ids_list: list[list[int]],
          device) -> torch.Tensor:
    """Token id lists -> (N, H) f32 unit vectors: the mean of the last
    hidden state over every token ([CLS] and [SEP] included), L2
    normalised."""
    strict_f32()
    out = torch.empty((len(ids_list), config["hidden_size"]), device=device)
    for r, ids in enumerate(ids_list):
        h = hidden_states(W, config, torch.tensor(ids, device=device))
        out[r] = torch.nn.functional.normalize(h.mean(0), dim=-1, eps=1e-12)
    return out
