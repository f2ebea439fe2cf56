"""Qwen3's seeded weights and work counts for the yardstick: each tensor's
law and seed, the model operations of a text, the operations and bytes
of each span's launches (attention, SwiGLU FFN, projections), and the
exact token count of a page of the long-ingest traffic under the
synthetic tokenizer.json.

FLOPs are the model's (2 a multiply-add), at the widths of the
configuration's published keys: the projections take 2·(H·(nh + 2nkv)·hd
+ nh·hd·H + 3·H·I) a token and layer (13.89 G a token over
Qwen3-Embedding-8B's 36 layers), and the scores and the weighted sum
4·nh·hd for each key a token attends to: causal, a text of n tokens
attends to n(n + 1) / 2 keys in each layer.
"""

from __future__ import annotations

import re
import zlib

import numpy as np

from benchmark import seeds

MATRIX_STD = 0.02   # config.json's initializer_range
NORM_STD = 0.1      # norm weights 1 + N(0, NORM_STD)


def head_dim(config: dict) -> int:
    return config.get("head_dim") or (config["hidden_size"]
                                      // config["num_attention_heads"])


def layer_shapes(config: dict, i: int) -> dict[str, tuple[int, ...]]:
    """Layer i's tensors by HF name (bare), torch (out, in)."""
    H, I, hd = config["hidden_size"], config["intermediate_size"], \
        head_dim(config)
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    p = f"layers.{i}."
    return {p + "input_layernorm.weight": (H,),
            p + "post_attention_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (nh * hd, H),
            p + "self_attn.k_proj.weight": (nkv * hd, H),
            p + "self_attn.v_proj.weight": (nkv * hd, H),
            p + "self_attn.o_proj.weight": (H, nh * hd),
            p + "self_attn.q_norm.weight": (hd,),
            p + "self_attn.k_norm.weight": (hd,),
            p + "mlp.gate_proj.weight": (I, H),
            p + "mlp.up_proj.weight": (I, H),
            p + "mlp.down_proj.weight": (H, I)}


def shapes(config: dict) -> dict[str, tuple[int, ...]]:
    """Every tensor of the checkpoint, in the order it is written."""
    out = {"embed_tokens.weight": (config["vocab_size"],
                                   config["hidden_size"])}
    for i in range(config["num_hidden_layers"]):
        out.update(layer_shapes(config, i))
    out["norm.weight"] = (config["hidden_size"],)
    return out


def tensor(name: str, shape: tuple[int, ...], seed: int, device):
    """One tensor of the seeded checkpoint, bf16 on `device`: matrices and
    the embedding N(0, MATRIX_STD), norm weights 1 + N(0, NORM_STD), each
    from a generator of its own (the run's weight seed and the name), so
    a layer's tensors can be made again alone."""
    import torch
    g = torch.Generator(device=device).manual_seed(seeds.torch_seed(
        seed, zlib.crc32(name.encode())))
    t = torch.randn(shape, generator=g, device=device)
    t = 1.0 + NORM_STD * t if len(shape) == 1 else MATRIX_STD * t
    return t.to(torch.bfloat16)


# -- work ---------------------------------------------------------------------

def projection_flops(config: dict) -> int:
    """Operations of one token's projections through every layer."""
    H, I, hd = config["hidden_size"], config["intermediate_size"], \
        head_dim(config)
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    return 2 * config["num_hidden_layers"] * (
        H * (nh + 2 * nkv) * hd + nh * hd * H + 3 * H * I)


def causal_keys(n: int) -> int:
    """Keys the n tokens of a text attend to, over all of them."""
    return n * (n + 1) // 2


def attention_flops_per_key(config: dict) -> int:
    return 4 * config["num_attention_heads"] * head_dim(config)


def encoder_flops(n_tokens: int, config: dict) -> int:
    """Model operations of one text of n tokens through the encoder."""
    return (n_tokens * projection_flops(config)
            + config["num_hidden_layers"] * attention_flops_per_key(config)
            * causal_keys(n_tokens))


def attention_work(keys: int, real: int, B: int, S: int, config: dict
                   ) -> tuple[float, float]:
    """(operations, bytes) of one causal attention launch over a (B, S)
    batch whose `real` tokens attend to `keys` keys in all: q, k and v of
    the real tokens read once and the (B, S) context written once, in
    bf16."""
    nh, nkv, hd = (config["num_attention_heads"],
                   config["num_key_value_heads"], head_dim(config))
    return (float(attention_flops_per_key(config) * keys),
            2.0 * hd * ((nh + 2 * nkv) * real + nh * B * S))


def swiglu_work(B: int, S: int, config: dict) -> tuple[float, float]:
    """(operations, bytes) of one SwiGLU FFN's two launches at (B, S): H ->
    2I and I -> H over every row; W_gu and W_d in bf16, the normed input
    (bf16) and its Σ parts read, the (M, I) bf16 written and read back,
    the f32 residual read and written, the next norm's bf16 written."""
    H, I = config["hidden_size"], config["intermediate_size"]
    M = B * S
    return (2.0 * M * 3 * H * I,
            2.0 * 3 * H * I + M * (2 * H + 2 * 2 * I + 4 * H + 4 * H + 2 * H))


def proj_work(kind: str, B: int, S: int, config: dict
              ) -> tuple[float, float]:
    """(operations, bytes) of one projection launch: "qkv" (H -> (nh +
    2nkv)·hd, the input bf16, qkv bf16 out) or "out" (nh·hd -> H, the
    context bf16 in, the f32 residual read, h f32 and the next norm's
    bf16 written), the weights in bf16."""
    H, hd = config["hidden_size"], head_dim(config)
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    M = B * S
    if kind == "qkv":
        N = (nh + 2 * nkv) * hd
        return 2.0 * M * H * N, 2.0 * H * N + M * (2 * H + 2 * N)
    return (2.0 * M * nh * hd * H,
            2.0 * nh * hd * H + M * (2 * nh * hd + 4 * H + 4 * H + 2 * H))


# -- tokens of a page of warc-ingest-qwen3, by construction ---------------

# Qwen2's pattern over ASCII text (\p{L} = [A-Za-z], \p{N} = [0-9])
_ASCII = re.compile(r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\nA-Za-z0-9]?[A-Za-z]+"
                    r"|[0-9]| ?[^\sA-Za-z0-9]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)"
                    r"|\s+")


def token_count(text: str, words: frozenset) -> int:
    """Byte-level BPE pieces of ASCII `text` under the synthetic
    tokenizer.json (kinds/warc_ingest_qwen3.py::tokenizer_json): its
    merges join a space and a word of `words` (any prefix of one: they
    build each word a letter at a time) into one piece and nothing else,
    so a pre-token " w..." is one piece for the longest such prefix and
    one a byte for the rest, and every other byte is a piece."""
    if not text.isascii():
        raise ValueError("token_count counts ASCII text")
    count = 0
    for m in _ASCII.finditer(text):
        s = m.group()
        if len(s) > 1 and s[0] == " " and s[1].isalpha():
            run = s[1:]
            k = next((k for k in range(len(run), 0, -1) if run[:k] in words),
                     0)
            count += 1 + len(run) - k if k else len(s)
        else:
            count += len(s)
    return count


def page_tokens(prompt: str, title: str, text: str, words: frozenset,
                max_len: int) -> int:
    """Tokens the node encodes for a stored page: the document prompt,
    the title, a newline and the text, then <|endoftext|>, cut at
    max_len."""
    return min(max_len, token_count(f"{prompt}{title}\n{text}", words) + 1)


def page_sample(rng: np.random.Generator, ids: np.ndarray, n: int
                ) -> list[int]:
    return sorted(rng.choice(ids, min(n, len(ids)), replace=False).tolist())
