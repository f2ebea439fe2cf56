"""Qwen3's sentence encoder in plain torch, f32, TF32 off: the equations of
reference/qwen3_plain.py at the checkout's root (HF transformers'
modeling_qwen3.py), computed a layer at a time over all the judged texts,
so that an 8B model fits beside nothing else: each layer's weights are
made from the seed when it is reached and dropped after it, each text's
(n, H) state carried from layer to layer, and the causal attention run
in blocks of query rows.

    x = E[ids]; each layer: a = RMS_in(x); q, k, v = a·Wq, a·Wk, a·Wv;
    q, k = RoPE(RMS_q(q)), RoPE(RMS_k(k)); h = x + Wo·attn(q, k, v)
    (causal, query head j on kv head j // (nh / nkv)); m = RMS_post(h);
    x = h + Wd·(silu(m·Wg) ⊙ m·Wu); then RMS_final at the last token,
    L2-normalised.

Each text runs alone at positions 0 .. n − 1 (a left-padded batch gives
the same: RoPE's scores depend on position differences only). Weights
are HF Qwen3Model tensor names, bare, given by a function of the name.
"""

from __future__ import annotations

import torch

from benchmark.reference.encoder import strict_f32

ROWS = 1024  # query rows an attention block
LAYER_NAMES = ("input_layernorm.weight", "post_attention_layernorm.weight",
               "self_attn.q_proj.weight", "self_attn.k_proj.weight",
               "self_attn.v_proj.weight", "self_attn.o_proj.weight",
               "self_attn.q_norm.weight", "self_attn.k_norm.weight",
               "mlp.gate_proj.weight", "mlp.up_proj.weight",
               "mlp.down_proj.weight")


def _rope(S: int, hd: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.int64,
                                        device=device).float() / hd))
    ang = torch.arange(S, device=device).float()[:, None] * inv[None, :]
    ang = torch.cat((ang, ang), dim=-1)
    return ang.cos(), ang.sin()


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat((-x[..., h:], x[..., :h]), dim=-1) * sin


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _attend(q, k, v) -> torch.Tensor:
    """(nh, S, hd) q and (nkv, S, hd) k, v -> (S, nh·hd): causal softmax
    attention by blocks of ROWS query rows."""
    nh, S, hd = q.shape
    group = nh // k.shape[0]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    out = torch.empty((S, nh * hd), device=q.device)
    for r0 in range(0, S, ROWS):
        r1 = min(S, r0 + ROWS)
        s = (q[:, r0:r1] @ k[:, :r1].transpose(-1, -2)) * hd ** -0.5
        i = torch.arange(r0, r1, device=q.device)[:, None]
        j = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(j > i, float("-inf"))
        ctx = torch.softmax(s, dim=-1) @ v[:, :r1]
        out[r0:r1] = ctx.transpose(0, 1).reshape(r1 - r0, nh * hd)
    return out


def layer(W, config: dict, i: int, x: torch.Tensor, cos, sin
          ) -> torch.Tensor:
    """Layer i on one text's (S, H) f32 state; W(name) gives a tensor."""
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or config["hidden_size"] // nh
    eps, S = config["rms_norm_eps"], x.shape[0]
    p = f"layers.{i}."
    a = _rms(x, W(p + "input_layernorm.weight"), eps)
    q = (a @ W(p + "self_attn.q_proj.weight").T).view(S, nh, hd)
    k = (a @ W(p + "self_attn.k_proj.weight").T).view(S, nkv, hd)
    v = (a @ W(p + "self_attn.v_proj.weight").T).view(S, nkv, hd)
    q = _rms(q, W(p + "self_attn.q_norm.weight"), eps).transpose(0, 1)
    k = _rms(k, W(p + "self_attn.k_norm.weight"), eps).transpose(0, 1)
    ctx = _attend(_rotate(q, cos, sin), _rotate(k, cos, sin),
                  v.transpose(0, 1))
    h = x + ctx @ W(p + "self_attn.o_proj.weight").T
    m = _rms(h, W(p + "post_attention_layernorm.weight"), eps)
    g = torch.nn.functional.silu(m @ W(p + "mlp.gate_proj.weight").T)
    return h + (g * (m @ W(p + "mlp.up_proj.weight").T)) \
        @ W(p + "mlp.down_proj.weight").T


@torch.no_grad()
def embed(weight, config: dict, ids_list: list[list[int]],
          device) -> torch.Tensor:
    """Token id lists -> (N, H) f32 unit vectors: the final norm of each
    text's last token, L2-normalised. weight(names) -> {name: tensor}
    makes the named tensors (a layer's at a time) on `device`."""
    strict_f32()
    hd = config.get("head_dim") or (config["hidden_size"]
                                    // config["num_attention_heads"])
    emb = weight(["embed_tokens.weight"])["embed_tokens.weight"]
    xs = [emb[torch.tensor(ids, device=device)].float() for ids in ids_list]
    del emb
    top = max(len(ids) for ids in ids_list)
    cos, sin = _rope(top, hd, config["rope_theta"], device)
    for i in range(config["num_hidden_layers"]):
        W = {k: v.float() for k, v in weight(
            [f"layers.{i}.{n}" for n in LAYER_NAMES]).items()}
        for r, x in enumerate(xs):
            n = x.shape[0]
            xs[r] = layer(W.__getitem__, config, i, x, cos[:n], sin[:n])
        del W
    w = weight(["norm.weight"])["norm.weight"].float()
    out = torch.stack([_rms(x[-1], w, config["rms_norm_eps"]) for x in xs])
    return torch.nn.functional.normalize(out, dim=-1, eps=1e-12)
