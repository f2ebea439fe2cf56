"""BERT and MPNet sentence encoders in plain torch, f32, TF32 off.

What a node's encoder computes for a text, from HF's modeling_bert.py and
modeling_mpnet.py (post-LN layers, erf GELU; MPNet's positions offset
from the pad id and its T5-style relative-position bias shared by every
layer), then the sentence-transformers mean pool over the real tokens and
an L2 normalize. Weights are a dict of HF tensor names (the names of the
checkpoint the harness writes), bare of any `bert.` / `mpnet.` prefix.
Rows of a batch are right-padded and their padding keys masked, which
leaves every real token's state as if the text ran alone.
"""

from __future__ import annotations

import math

import torch

_ATTN = {"bert": dict(q="attention.self.query", k="attention.self.key",
                      v="attention.self.value", o="attention.output.dense",
                      ln="attention.output.LayerNorm"),
         "mpnet": dict(q="attention.attn.q", k="attention.attn.k",
                       v="attention.attn.v", o="attention.attn.o",
                       ln="attention.LayerNorm")}


def strict_f32() -> None:
    """True f32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def relative_bucket(S: int, num_buckets: int = 32, max_distance: int = 128,
                    device=None) -> torch.Tensor:
    """(S, S) bucket of key j's offset from query i (HF
    MPNetEncoder.relative_position_bucket of memory - context)."""
    ctx = torch.arange(S, device=device)[:, None]
    mem = torch.arange(S, device=device)[None, :]
    n = -(mem - ctx)
    half = num_buckets // 2
    ret = (n < 0).long() * half
    n = n.abs()
    exact = half // 2
    large = exact + (torch.log(n.float().clamp_min(1) / exact)
                     / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = large.clamp_max(half - 1)
    return ret + torch.where(n < exact, n, large)


def _ln(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, eps)


def _linear(x, w, b):
    return x @ w.T + b


@torch.no_grad()
def hidden_states(weights: dict, config: dict, ids: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(B, S) ids and 0/1 mask -> (B, S, H) f32 last hidden state."""
    kind = config["model_type"]
    eps = config["layer_norm_eps"]
    H, nh = config["hidden_size"], config["num_attention_heads"]
    hd = H // nh
    B, S = ids.shape
    W = weights
    if kind == "mpnet":
        pad = config["pad_token_id"]
        pos = torch.cumsum(mask, dim=1) * mask + pad
        x = (W["embeddings.word_embeddings.weight"][ids]
             + W["embeddings.position_embeddings.weight"][pos])
        bucket = relative_bucket(S, config["relative_attention_num_buckets"],
                                 device=ids.device)
        rel = W["encoder.relative_attention_bias.weight"][bucket]
        rel = rel.permute(2, 0, 1)[None]                   # (1, nh, S, S)
    else:
        x = (W["embeddings.word_embeddings.weight"][ids]
             + W["embeddings.position_embeddings.weight"][:S][None]
             + W["embeddings.token_type_embeddings.weight"][0])
        rel = None
    x = _ln(x, W["embeddings.LayerNorm.weight"],
            W["embeddings.LayerNorm.bias"], eps)
    key_bias = torch.where(mask.bool(), 0.0, float("-inf"))[:, None, None, :]
    names = _ATTN[kind]
    for i in range(config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."

        def lin(name, t):
            return _linear(t, W[p + name + ".weight"], W[p + name + ".bias"])

        def heads(t):
            return t.view(B, S, nh, hd).transpose(1, 2)
        q, k, v = (heads(lin(names[h], x)) for h in "qkv")
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if rel is not None:
            scores = scores + rel
        probs = torch.softmax(scores + key_bias, dim=-1)
        ctx = (probs @ v).transpose(1, 2).reshape(B, S, H)
        x = _ln(x + lin(names["o"], ctx), W[p + names["ln"] + ".weight"],
                W[p + names["ln"] + ".bias"], eps)
        h = torch.nn.functional.gelu(lin("intermediate.dense", x))
        x = _ln(x + lin("output.dense", h), W[p + "output.LayerNorm.weight"],
                W[p + "output.LayerNorm.bias"], eps)
    return x


@torch.no_grad()
def embed(weights: dict, config: dict, ids_list: list[list[int]],
          device, pad_id: int, batch_tokens: int = 1 << 16) -> torch.Tensor:
    """Token id lists -> (N, H) f32 unit vectors (masked mean pool over
    the real tokens, [CLS] and [SEP] included, then L2 normalize), in
    blocks of about `batch_tokens` padded tokens, rows sorted by length."""
    order = sorted(range(len(ids_list)), key=lambda r: len(ids_list[r]))
    out = torch.empty(len(ids_list), config["hidden_size"], device=device)
    start = 0
    while start < len(order):
        end = start + 1  # lengths ascend, so the last row is the longest
        while end < len(order) and \
                (end + 1 - start) * len(ids_list[order[end]]) <= batch_tokens:
            end += 1
        rows = order[start:end]
        S = max(len(ids_list[r]) for r in rows)
        ids = torch.full((len(rows), S), pad_id, dtype=torch.long)
        mask = torch.zeros((len(rows), S), dtype=torch.long)
        for j, r in enumerate(rows):
            ids[j, :len(ids_list[r])] = torch.tensor(ids_list[r])
            mask[j, :len(ids_list[r])] = 1
        ids, mask = ids.to(device), mask.to(device)
        h = hidden_states(weights, config, ids, mask)
        m = mask[..., None].float()
        pooled = (h * m).sum(1) / m.sum(1)
        out[torch.tensor(rows, device=device)] = \
            torch.nn.functional.normalize(pooled, dim=-1, eps=1e-12)
        start = end
    return out
