"""Seeded encoder weights and the checkpoint directory the node loads.

The weights are made on the device from the seed in two calls (every
matrix and embedding table from one normal draw, every bias and
LayerNorm parameter from another), rounded to bf16, the type the node
serves them in, so the node's cast loses nothing and the reference
computes on the very same values in f32. Distributions as chip_smoke.py's
_encoder_tree: matrices and tables std 0.05, biases std 0.1, LayerNorm
scales 1 + N(0, 0.1), MPNet's relative-position table std 0.5; but the
word embeddings std 0.5, which parts distinct queries (all-MiniLM-L6-v2:
mean cosine of two random queries 0.74, against 0.90 at std 0.05).

`write_checkpoint` writes config.json (the configuration's published
config.json), model.safetensors (F32, HF tensor names) and vocab.txt with
this file's own safetensors writer.
"""

from __future__ import annotations

import json
import os
import struct

import torch

from benchmark import texts


WORD = "embeddings.word_embeddings.weight"


def shapes(config: dict) -> tuple[dict, dict]:
    """({name: shape} of the matrices and tables, {name: (shape, base)} of
    the biases and LayerNorm parameters), HF names, torch (out, in)."""
    H, I = config["hidden_size"], config["intermediate_size"]
    mpnet = config["model_type"] == "mpnet"
    mats = {"embeddings.word_embeddings.weight": (config["vocab_size"], H),
            "embeddings.position_embeddings.weight":
                (config["max_position_embeddings"], H)}
    vecs = {"embeddings.LayerNorm.weight": ((H,), 1.0),
            "embeddings.LayerNorm.bias": ((H,), 0.0)}
    if mpnet:
        attn = dict(q="attention.attn.q", k="attention.attn.k",
                    v="attention.attn.v", o="attention.attn.o",
                    ln="attention.LayerNorm")
    else:
        mats["embeddings.token_type_embeddings.weight"] = \
            (config["type_vocab_size"], H)
        attn = dict(q="attention.self.query", k="attention.self.key",
                    v="attention.self.value", o="attention.output.dense",
                    ln="attention.output.LayerNorm")
    for i in range(config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for h in "qkvo":
            mats[p + attn[h] + ".weight"] = (H, H)
            vecs[p + attn[h] + ".bias"] = ((H,), 0.0)
        mats[p + "intermediate.dense.weight"] = (I, H)
        vecs[p + "intermediate.dense.bias"] = ((I,), 0.0)
        mats[p + "output.dense.weight"] = (H, I)
        vecs[p + "output.dense.bias"] = ((H,), 0.0)
        for ln in (attn["ln"], "output.LayerNorm"):
            vecs[p + ln + ".weight"] = ((H,), 1.0)
            vecs[p + ln + ".bias"] = ((H,), 0.0)
    if mpnet:
        vecs["encoder.relative_attention_bias.weight"] = (
            (config["relative_attention_num_buckets"],
             config["num_attention_heads"]), 0.0)
    return mats, vecs


def make(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{HF name: f32 tensor on `device`} whose values are bf16 values."""
    mats, vecs = shapes(config)
    g = torch.Generator(device=device).manual_seed(seed)
    n_m = sum(a * b for a, b in mats.values())
    n_v = sum(torch.Size(s).numel() for s, _ in vecs.values())
    flat_m = torch.randn(n_m, generator=g, device=device) * 0.05
    flat_v = torch.randn(n_v, generator=g, device=device) * 0.1
    out, o = {}, 0
    for name, shape in mats.items():
        n = shape[0] * shape[1]
        t = flat_m[o:o + n].view(shape)
        # token identity dominates the embedding sum, so distinct texts
        # keep apart through the layers
        out[name] = t * 10.0 if name == WORD else t
        o += n
    o = 0
    for name, (shape, base) in vecs.items():
        n = torch.Size(shape).numel()
        t = flat_v[o:o + n].view(shape)
        if name.endswith("relative_attention_bias.weight"):
            t = t * 5.0
        out[name] = t + base
        o += n
    return {k: v.to(torch.bfloat16).float() for k, v in out.items()}


def write_safetensors(tensors: dict[str, torch.Tensor], path: str) -> int:
    """F32 safetensors file of `tensors` (any device); returns its bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().float().contiguous().cpu().numpy().tobytes())
    return 8 + len(blob) + offset


def write_checkpoint(model_dir: str, config: dict,
                     tensors: dict[str, torch.Tensor]) -> int:
    """The checkpoint a user drops into model_dir; returns bytes written."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config["published"], f, indent=2)
    vocab = texts.vocab_for(config)
    with open(os.path.join(model_dir, "vocab.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return write_safetensors(tensors,
                             os.path.join(model_dir, "model.safetensors"))
