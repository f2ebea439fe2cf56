"""Encoder parameters: seeded random init, the bridge from the reference's
parameter tree, and HF checkpoints (safetensors + config.json).

Port of dawnsearch_tpu/models/weights.py for the `bert`, `roberta` and
`mpnet` families: init_params (:26-61), from_hf_tensors / to_hf_tensors
(:76-155, :247-297), config_from_hf (:169-211), load_params (:214-240) and
load_safetensors / save_safetensors (:158-166, :300-310). Both packages
use one layout, the reference's stacked tree:

    {"embeddings": {"word", "position", "token_type", "ln_scale", "ln_bias"},
     "layers": {"qkv_w" (L, H, 3H), "qkv_b" (L, 3H), "attn_out_w" (L, H, H),
                "attn_out_b", "attn_ln_scale", "attn_ln_bias",
                "ffn_in_w" (L, H, I), "ffn_in_b" (L, I), "ffn_out_w" (L, I, H),
                "ffn_out_b", "ffn_ln_scale", "ffn_ln_bias"},
     "rel_bias" (num_buckets, nh)}      # mpnet only, which has no token_type

RoBERTa's checkpoints use BERT's names under a `roberta.` prefix (or
none), with a one-row token-type table. HF's MPNet names its attention `attention.attn.{q,k,v,o}` and
`attention.LayerNorm` and keeps the relative-position table at
`encoder.relative_attention_bias.weight`; the q/k/v linears are fused into
qkv on import and split again on export, as for BERT.

Matrices are (in, out), so x·W is a plain product and the kernels read
them row-major without a transpose; HF's torch Linear stores (out, in), so
every matrix is transposed on import and export. The tree here holds f32
CPU tensors; BertModel casts (or, for K4, quantizes) the matrices once, on
load.

The safetensors file format is read and written here in numpy (an 8-byte
little-endian header length, a JSON header of dtype / shape / data_offsets
per tensor, then the raw little-endian bytes), so the port needs no
`safetensors` package. It reads the dtypes the reference's numpy reader
reads and refuses any other (BF16, F8) by the tensor's name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

from dawnsearch_tpu_torch.models.bert import MINILM_L6, BertConfig, Params

# safetensors dtype tag -> numpy little-endian dtype
ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
             "I32": "<i4", "I16": "<i2", "I8": "i1", "U64": "<u8",
             "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}
_ST_TAGS = {np.dtype(v): k for k, v in ST_DTYPES.items()}

def init_params(generator: torch.Generator,
                cfg: BertConfig = MINILM_L6) -> Params:
    """Random init on the CPU (normal, std 0.02, like BERT; LayerNorm
    scales 1, biases 0). The same seed does not give the reference's
    numbers: tests that compare the two packages make their weights with
    numpy and bridge them (params_from_numpy)."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32)

    emb = {
        "word": w(cfg.vocab_size, H),
        "position": w(cfg.max_position_embeddings, H),
        "ln_scale": const(1.0, H),
        "ln_bias": const(0.0, H),
    }
    if cfg.model_type != "mpnet":  # mpnet has no token types
        emb["token_type"] = w(cfg.type_vocab_size, H)
    layers = {
        "qkv_w": w(L, H, 3 * H),
        "qkv_b": const(0.0, L, 3 * H),
        "attn_out_w": w(L, H, H),
        "attn_out_b": const(0.0, L, H),
        "attn_ln_scale": const(1.0, L, H),
        "attn_ln_bias": const(0.0, L, H),
        "ffn_in_w": w(L, H, I),
        "ffn_in_b": const(0.0, L, I),
        "ffn_out_w": w(L, I, H),
        "ffn_out_b": const(0.0, L, H),
        "ffn_ln_scale": const(1.0, L, H),
        "ffn_ln_bias": const(0.0, L, H),
    }
    out = {"embeddings": emb, "layers": layers}
    if cfg.model_type == "mpnet":
        out["rel_bias"] = w(cfg.relative_attention_num_buckets, cfg.num_heads)
    return out


def params_from_numpy(tree: Mapping[str, Any]) -> Params:
    """The reference's parameter tree with numpy (or array-like) leaves ->
    the same tree of f32 CPU tensors."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))


# -- safetensors ----------------------------------------------------------

class Bf16:
    """A BF16 safetensors tensor left as its bits: a read-only uint16
    memory map, which `torch()` copies once into a bf16 tensor (the host
    never holds it widened to f32)."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.shape = bits.shape

    def torch(self) -> torch.Tensor:
        return torch.from_numpy(self.bits.view(np.int16).copy()).view(
            torch.bfloat16)


def read_safetensors(path: str, bf16: bool | str = False
                     ) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file, as read-only numpy arrays over a
    memory map (nothing is copied until a caller converts). bf16=True
    also reads BF16 tensors, widened to f32 (a copy): ModernBERT
    checkpoints are published in BF16. bf16="bits" reads them as Bf16
    (no copy), for a model that moves them to its card one at a time
    (Qwen3's 15 GB)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header)")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the end of "
                             f"the file ({size} bytes)")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        tag, shape = info["dtype"], tuple(info["shape"])
        if bf16 and tag == "BF16":
            begin, end = info["data_offsets"]
            if not 0 <= begin <= end <= data.size or \
                    end - begin != 2 * int(np.prod(shape)):
                raise ValueError(f"{path}: tensor {name!r} ({tag} {shape}) "
                                 f"has bad data_offsets {info['data_offsets']}")
            u16 = data[begin:end].view("<u2").reshape(shape)
            if bf16 == "bits":
                out[name] = Bf16(u16)
                continue
            bits = u16.reshape(-1).astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
            continue
        if tag not in ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {tag}, which "
                             f"this reader does not take (it reads "
                             f"{', '.join(ST_DTYPES)})")
        dt = np.dtype(ST_DTYPES[tag])
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= data.size or \
                end - begin != dt.itemsize * int(np.prod(shape)):
            raise ValueError(f"{path}: tensor {name!r} ({tag} {shape}) has "
                             f"bad data_offsets {info['data_offsets']}")
        out[name] = data[begin:end].view(dt).reshape(shape)
    return out


def write_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write numpy arrays as a safetensors file (tensors in name order,
    the header padded with spaces to a multiple of 8 bytes)."""
    header, arrays, offset = {}, [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name], order="C")  # keeps 0-d arrays 0-d
        if a.dtype not in _ST_TAGS:
            raise ValueError(f"tensor {name!r}: dtype {a.dtype} has no "
                             "safetensors tag here")
        header[name] = {"dtype": _ST_TAGS[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        arrays.append(a)
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in arrays:
            f.write(a.tobytes())


# -- HF tensor names <-> the stacked tree -----------------------------------

# each family's names of a layer's attention tensors (RoBERTa's are BERT's)
_BERT_NAMES = dict(q="attention.self.query", k="attention.self.key",
                   v="attention.self.value", o="attention.output.dense",
                   attn_ln="attention.output.LayerNorm")
_NAMES = {"bert": _BERT_NAMES, "roberta": _BERT_NAMES,
          "mpnet": dict(q="attention.attn.q", k="attention.attn.k",
                        v="attention.attn.v", o="attention.attn.o",
                        attn_ln="attention.LayerNorm")}
_REL_BIAS = "encoder.relative_attention_bias.weight"


def _strip_prefix(tensors: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Accept `bert.`-, `roberta.`- or `mpnet.`-prefixed and bare tensor
    namings."""
    out = {}
    for name, t in tensors.items():
        for pre in ("bert.", "mpnet.", "roberta."):
            if name.startswith(pre):
                name = name[len(pre):]
                break
        out[name] = t
    return out


def from_hf_tensors(tensors: Mapping[str, np.ndarray],
                    cfg: BertConfig = MINILM_L6) -> Params:
    """HF BertModel / RobertaModel / MPNetModel tensor dict (numpy) ->
    stacked tree of f32
    tensors. Tensors it does not use (position_ids, the pooler) are
    ignored; a checkpoint with more layers than cfg is refused."""
    t = _strip_prefix(tensors)
    mpnet = cfg.model_type == "mpnet"

    def get(name: str) -> np.ndarray:
        if name not in t:
            raise KeyError(f"missing tensor {name!r}; have {sorted(t)[:8]}...")
        return np.asarray(t[name], dtype=np.float32)

    emb = {
        "word": get("embeddings.word_embeddings.weight"),
        "position": get("embeddings.position_embeddings.weight"),
        "ln_scale": get("embeddings.LayerNorm.weight"),
        "ln_bias": get("embeddings.LayerNorm.bias"),
    }
    if not mpnet:
        emb["token_type"] = get("embeddings.token_type_embeddings.weight")
    per_layer: dict[str, list[np.ndarray]] = {k: [] for k in (
        "qkv_w", "qkv_b", "attn_out_w", "attn_out_b",
        "attn_ln_scale", "attn_ln_bias",
        "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b",
        "ffn_ln_scale", "ffn_ln_bias",
    )}
    n = _NAMES[cfg.model_type]
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        per_layer["qkv_w"].append(np.concatenate(
            [get(p + n[h] + ".weight").T for h in "qkv"], axis=1))
        per_layer["qkv_b"].append(np.concatenate(
            [get(p + n[h] + ".bias") for h in "qkv"]))
        per_layer["attn_out_w"].append(get(p + n["o"] + ".weight").T)
        per_layer["attn_out_b"].append(get(p + n["o"] + ".bias"))
        per_layer["attn_ln_scale"].append(get(p + n["attn_ln"] + ".weight"))
        per_layer["attn_ln_bias"].append(get(p + n["attn_ln"] + ".bias"))
        per_layer["ffn_in_w"].append(get(p + "intermediate.dense.weight").T)
        per_layer["ffn_in_b"].append(get(p + "intermediate.dense.bias"))
        per_layer["ffn_out_w"].append(get(p + "output.dense.weight").T)
        per_layer["ffn_out_b"].append(get(p + "output.dense.bias"))
        per_layer["ffn_ln_scale"].append(get(p + "output.LayerNorm.weight"))
        per_layer["ffn_ln_bias"].append(get(p + "output.LayerNorm.bias"))

    # a checkpoint deeper than cfg (an L12 file against the L6 default
    # because config.json is missing) must fail, not serve half an encoder
    extra = f"encoder.layer.{cfg.num_layers}."
    if any(k.startswith(extra) for k in t):
        raise ValueError(
            f"checkpoint has layers beyond the configured {cfg.num_layers} "
            f"(found {extra}*); put the model's real config.json next to "
            "model.safetensors")
    out = {"embeddings": emb,
           "layers": {k: np.stack(v) for k, v in per_layer.items()}}
    if mpnet:
        out["rel_bias"] = get(_REL_BIAS)
    return params_from_numpy(out)


def to_hf_tensors(params: Params, cfg: BertConfig = MINILM_L6
                  ) -> dict[str, np.ndarray]:
    """Stacked tree -> HF BertModel / RobertaModel / MPNetModel tensor dict
    (inverse of
    from_hf_tensors): un-stack layers, split the fused QKV, transpose back
    to torch's (out, in)."""
    def np_(x) -> np.ndarray:
        return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                          dtype=np.float32)

    H, n = cfg.hidden_size, _NAMES[cfg.model_type]
    emb = params["embeddings"]
    out = {
        "embeddings.word_embeddings.weight": np_(emb["word"]),
        "embeddings.position_embeddings.weight": np_(emb["position"]),
        "embeddings.LayerNorm.weight": np_(emb["ln_scale"]),
        "embeddings.LayerNorm.bias": np_(emb["ln_bias"]),
    }
    if cfg.model_type == "mpnet":
        out[_REL_BIAS] = np_(params["rel_bias"])
    else:
        out["embeddings.token_type_embeddings.weight"] = np_(emb["token_type"])
    L = params["layers"]
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        qkv_w, qkv_b = np_(L["qkv_w"][i]), np_(L["qkv_b"][i])
        for j, h in enumerate("qkv"):
            out[p + n[h] + ".weight"] = qkv_w[:, j * H:(j + 1) * H].T
            out[p + n[h] + ".bias"] = qkv_b[j * H:(j + 1) * H]
        out[p + n["o"] + ".weight"] = np_(L["attn_out_w"][i]).T
        out[p + n["o"] + ".bias"] = np_(L["attn_out_b"][i])
        out[p + n["attn_ln"] + ".weight"] = np_(L["attn_ln_scale"][i])
        out[p + n["attn_ln"] + ".bias"] = np_(L["attn_ln_bias"][i])
        out[p + "intermediate.dense.weight"] = np_(L["ffn_in_w"][i]).T
        out[p + "intermediate.dense.bias"] = np_(L["ffn_in_b"][i])
        out[p + "output.dense.weight"] = np_(L["ffn_out_w"][i]).T
        out[p + "output.dense.bias"] = np_(L["ffn_out_b"][i])
        out[p + "output.LayerNorm.weight"] = np_(L["ffn_ln_scale"][i])
        out[p + "output.LayerNorm.bias"] = np_(L["ffn_ln_bias"][i])
    return out


def load_safetensors(path: str, cfg: BertConfig = MINILM_L6) -> Params:
    """Load an HF safetensors checkpoint (model.safetensors) from disk."""
    return from_hf_tensors(read_safetensors(path), cfg)


def save_safetensors(params: Params, path: str,
                     cfg: BertConfig = MINILM_L6) -> None:
    """Export params as an HF-naming safetensors checkpoint."""
    write_safetensors(to_hf_tensors(params, cfg), path)


def config_from_hf(model_dir: str) -> BertConfig | None:
    """A BertConfig from model_dir/config.json (None without one), so any
    BERT-, RoBERTa-, MPNet- or ModernBERT-family encoder loads by pointing
    model_dir at its checkout. Refuses a non-gelu activation (every kernel computes exact erf
    GELU) and an unknown family."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "bert")
    if model_type == "modernbert":
        from dawnsearch_tpu_torch.models import modernbert
        return modernbert.config_from_hf(hf, path)
    if model_type == "qwen3":
        from dawnsearch_tpu_torch.models import qwen3
        return qwen3.config_from_hf(hf, path)
    if model_type not in ("bert", "mpnet", "roberta"):
        raise ValueError(f"{path}: model_type={model_type!r} is not a "
                         "supported encoder family (bert, mpnet, roberta, "
                         "modernbert, qwen3)")
    act = hf.get("hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(
            f"{path}: hidden_act={act!r} is not supported (this encoder "
            "computes exact erf gelu); re-export the model or use a "
            "gelu-activation checkpoint")
    return BertConfig(
        vocab_size=hf.get("vocab_size", 30522),
        hidden_size=hf.get("hidden_size", 384),
        num_layers=hf.get("num_hidden_layers", 6),
        num_heads=hf.get("num_attention_heads", 12),
        intermediate_size=hf.get("intermediate_size", 1536),
        max_position_embeddings=hf.get("max_position_embeddings", 512),
        type_vocab_size=hf.get("type_vocab_size", 2),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        model_type=model_type,
        pad_token_id=hf.get("pad_token_id",
                            1 if model_type in ("mpnet", "roberta") else 0),
        relative_attention_num_buckets=hf.get(
            "relative_attention_num_buckets", 32),
    )


def load_params(model_dir: str | None, cfg: BertConfig | None = None,
                seed: int = 0) -> tuple[Params, bool, BertConfig]:
    """(params, pretrained, cfg): the checkpoint in model_dir when it has
    one, else seeded random weights. model_dir/config.json owns the shape
    fields and the family (model_type); the caller's cfg keeps its
    compute-policy fields (dtype and kernel routes)."""
    if model_dir:
        hf_cfg = config_from_hf(model_dir)
        if hf_cfg is not None:
            cfg = hf_cfg if cfg is None else dataclasses.replace(
                hf_cfg, dtype=cfg.dtype, attn_impl=cfg.attn_impl,
                pool_impl=cfg.pool_impl, layer_impl=cfg.layer_impl)
    if cfg is None:
        cfg = MINILM_L6
    modern = cfg.model_type == "modernbert"
    qwen = cfg.model_type == "qwen3"
    if modern:
        from dawnsearch_tpu_torch.models import modernbert
    if qwen:
        from dawnsearch_tpu_torch.models import qwen3
    if model_dir:
        for cand in ("model.safetensors", "pytorch_model.safetensors"):
            p = os.path.join(model_dir, cand)
            if os.path.exists(p):
                if modern:
                    return modernbert.from_hf_tensors(
                        read_safetensors(p, bf16=True), cfg), True, cfg
                if qwen:
                    return qwen3.from_hf_tensors(
                        read_safetensors(p, bf16="bits"), cfg), True, cfg
                return load_safetensors(p, cfg), True, cfg
    gen = torch.Generator().manual_seed(seed)
    if modern:
        return modernbert.init_params(gen, cfg), False, cfg
    if qwen:
        return qwen3.init_params(gen, cfg), False, cfg
    return init_params(gen, cfg), False, cfg
