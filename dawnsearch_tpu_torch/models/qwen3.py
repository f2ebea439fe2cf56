"""Qwen3 embedding family (Qwen/Qwen3-Embedding-8B shape).

HF transformers' modeling_qwen3.py (Qwen3Model) is the oracle;
reference/qwen3_plain.py writes its equations out in plain f32 torch, and
the tests hold this model to both. Qwen3 is a decoder's block used as an
encoder, unlike every other family the port serves:

- causal attention: token i attends to keys j <= i (and to real keys);
- grouped-query attention: num_key_value_heads key/value heads of 128,
  query head j reading head j // (nh / nkv);
- q and k are RMS-normed per head over their 128 dims (learned 128-wide
  weights), then rotated by position (RoPE, θ = rope_theta, pairs (d, d +
  64));
- pre-norm with RMSNorm (w ⊙ v / sqrt(mean(v²) + eps), in f32): x = x +
  attn(RMS_in(x)), x = x + down(silu(gate(RMS_post(x))) ⊙ up(RMS_post(x)));
  no biases, no position embeddings;
- the sentence embedding is the final norm of the last real token's
  hidden state, L2-normalised (last-token pooling; the tokenizer appends
  <|endoftext|> to every text), not a mean.

A layer runs the kernels of ops/qwen3.py (route "layer", bf16, on a card:
five launches, the residual stream in f32 between them) or their plain
twins (any route on the CPU). layer_impl = "layer_i8" on a card is the
W8A8 form, the control of the benchmark's comparison: the four
projections (QKV, O, gate/up, down) on K4's s8 pieces (ops/layer.py::
quant_rows, _gemm_i8 and i8_weight), the norms, RoPE and SwiGLU in plain
torch around them, the attention and the pool as on the bf16 route.

Parameters are HF's tensors by bare name (`model.` stripped), numpy,
safetensors BF16 bits (weights.Bf16) or torch tensors, each moved to the
device one at a time and transposed there to (in, out), so an 8B
checkpoint never lives on the host in f32:

    embed_tokens (V, H); layers.{i}.self_attn.{q,k,v,o}_proj (out, in),
    layers.{i}.self_attn.{q,k}_norm (128,), layers.{i}.input_layernorm,
    layers.{i}.post_attention_layernorm (H,), layers.{i}.mlp.{gate,up,
    down}_proj (out, in); norm (H,). lm_head is ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from dawnsearch_tpu_torch.models.bert import BertConfig, Params, _frozen
from dawnsearch_tpu_torch.ops import modernbert as mb
from dawnsearch_tpu_torch.ops import qwen3 as q3
from dawnsearch_tpu_torch.ops.layer import (_gemm_i8, _mm_i8, i8_weight,
                                            quant_rows)
from dawnsearch_tpu_torch.utils.logging import span



@dataclasses.dataclass(frozen=True)
class Qwen3Config(BertConfig):
    """BertConfig and what only Qwen3 has: grouped-query attention's
    key/value heads and the rotary θ."""
    num_kv_heads: int = 8
    rope_theta: float = 1000000.0


# Qwen/Qwen3-Embedding-8B's config.json (Qwen3-8B's dense block)
QWEN3_EMBEDDING_8B = Qwen3Config(
    vocab_size=151665, hidden_size=4096, num_layers=36, num_heads=32,
    intermediate_size=12288, max_position_embeddings=40960,
    type_vocab_size=0, layer_norm_eps=1e-6, model_type="qwen3",
    pad_token_id=151643, num_kv_heads=8, rope_theta=1000000.0)

EOS_ID = 151643  # <|endoftext|>: appended to every text, and the pad
MATRICES = ("qkv_w", "attn_out_w", "ffn_in_w", "ffn_out_w")


def config_from_hf(hf: dict, path: str) -> Qwen3Config:
    """A Qwen3Config from its config.json; refuses
    what this port does not compute (biases, a sliding window, another
    activation, a head dim other than the kernels', rope scaling)."""
    if hf.get("attention_bias", False):
        raise ValueError(f"{path}: attention_bias = true: the port serves "
                         "Qwen3 without biases, as published")
    if hf.get("use_sliding_window", False):
        raise ValueError(f"{path}: use_sliding_window = true is not "
                         "supported (every layer attends causally to all "
                         "earlier keys)")
    act = hf.get("hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"{path}: hidden_act={act!r} is not supported "
                         "(this encoder computes SwiGLU with silu)")
    if hf.get("rope_scaling"):
        raise ValueError(f"{path}: rope_scaling is not supported (the "
                         "port computes default RoPE)")
    H = hf.get("hidden_size", 4096)
    nh = hf.get("num_attention_heads", 32)
    hd = hf.get("head_dim", H // nh)
    if hd != q3.HEAD_DIM or nh * hd != H:
        raise ValueError(f"{path}: head_dim={hd} with {nh} heads at hidden "
                         f"size {H}: the port computes heads of "
                         f"{q3.HEAD_DIM} that tile the hidden size")
    return Qwen3Config(
        vocab_size=hf.get("vocab_size", 151665), hidden_size=H,
        num_layers=hf.get("num_hidden_layers", 36), num_heads=nh,
        intermediate_size=hf.get("intermediate_size", 12288),
        max_position_embeddings=hf.get("max_position_embeddings", 40960),
        type_vocab_size=0, layer_norm_eps=hf.get("rms_norm_eps", 1e-6),
        model_type="qwen3", pad_token_id=hf.get("pad_token_id", EOS_ID),
        num_kv_heads=hf.get("num_key_value_heads", nh),
        rope_theta=float(hf.get("rope_theta", 1000000.0)))


def hf_shapes(cfg: Qwen3Config) -> dict[str, tuple[int, ...]]:
    """Every tensor of a Qwen3Model checkpoint by bare name, (out, in)."""
    H, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    out = {"embed_tokens.weight": (cfg.vocab_size, H), "norm.weight": (H,)}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        out.update({
            p + "input_layernorm.weight": (H,),
            p + "post_attention_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (nh * hd, H),
            p + "self_attn.k_proj.weight": (nkv * hd, H),
            p + "self_attn.v_proj.weight": (nkv * hd, H),
            p + "self_attn.o_proj.weight": (H, nh * hd),
            p + "self_attn.q_norm.weight": (hd,),
            p + "self_attn.k_norm.weight": (hd,),
            p + "mlp.gate_proj.weight": (I, H),
            p + "mlp.up_proj.weight": (I, H),
            p + "mlp.down_proj.weight": (H, I)})
    return out


def from_hf_tensors(tensors, cfg: Qwen3Config) -> Params:
    """HF Qwen3Model tensors (names with or without `model.`; lm_head and
    unused names ignored) -> the bare-name dict this model takes, checked
    against the config's shapes. Nothing is converted here: the model
    moves each tensor to its device as it builds the layer."""
    t = {k[len("model."):] if k.startswith("model.") else k: v
         for k, v in tensors.items()}
    if any(k.startswith(f"layers.{cfg.num_layers}.") for k in t):
        raise ValueError(f"checkpoint has layers beyond the configured "
                         f"{cfg.num_layers}; put the model's real config.json "
                         "next to model.safetensors")
    out = {}
    for name, shape in hf_shapes(cfg).items():
        if name not in t:
            raise KeyError(f"missing tensor {name!r}; have {sorted(t)[:8]}...")
        if tuple(t[name].shape) != shape:
            raise ValueError(f"tensor {name!r} is {tuple(t[name].shape)}, "
                             f"config.json gives {shape}")
        out[name] = t[name]
    return out


def init_params(generator: torch.Generator, cfg: Qwen3Config) -> Params:
    """Seeded random weights by HF name (matrices normal, std 0.02, as
    config.json's initializer_range; norm weights 1 + N(0, 0.1))."""
    out = {}
    for name, shape in hf_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = 1.0 + 0.1 * torch.randn(shape, generator=generator)
        else:
            out[name] = 0.02 * torch.randn(shape, generator=generator)
    return out


def to_device(t, device, dtype) -> torch.Tensor:
    """One checkpoint tensor (numpy, weights.Bf16 bits or torch) on
    `device` in `dtype`; BF16 bits cross to the device as bf16 and widen
    there."""
    from dawnsearch_tpu_torch.models.weights import Bf16
    if isinstance(t, Bf16):
        t = t.torch()
    elif not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, dtype=np.float32, copy=True))
    return t.to(device=device).to(dtype)


def route(cfg: Qwen3Config, device) -> str:
    """"plain" (the twins: the CPU, any layer_impl), "layer" (the bf16
    kernels) or "layer_i8" (the W8A8 control) on a card."""
    if torch.device(device).type != "cuda":
        return "plain"
    if cfg.layer_impl not in ("layer", "layer_i8"):
        raise ValueError(f"Qwen3 on a card runs layer_impl 'layer' or "
                         f"'layer_i8', not {cfg.layer_impl!r}")
    if cfg.dtype != torch.bfloat16:
        raise ValueError("Qwen3 on a card runs compute_dtype 'bf16' only")
    return cfg.layer_impl


class Qwen3Layer(nn.Module):
    """One layer's weights in the form its route reads: (in, out) in the
    compute dtype (W_gu = [gate | up], interleaved on the kernel route),
    or K4's (codes, scales) pairs; the norm weights in f32."""

    def __init__(self, cfg: Qwen3Config, W: Params, i: int, rt: str, *,
                 device):
        super().__init__()
        p = f"layers.{i}."
        dt = cfg.dtype

        def mat(*names):
            return torch.cat([to_device(W[p + n + ".weight"], device, dt).t()
                              for n in names], dim=1)
        mats = {"qkv_w": ("self_attn.q_proj", "self_attn.k_proj",
                          "self_attn.v_proj"),
                "attn_out_w": ("self_attn.o_proj",),
                "ffn_in_w": ("mlp.gate_proj", "mlp.up_proj"),
                "ffn_out_w": ("mlp.down_proj",)}
        for name, hf in mats.items():
            w = mat(*hf)
            if rt == "layer_i8":
                codes, scales = i8_weight(w.float())
                setattr(self, name + "_codes", _frozen(codes, device,
                                                       torch.int8))
                setattr(self, name + "_scales", _frozen(scales, device))
                continue
            if rt == "layer" and name == "ffn_in_w":
                w = mb.interleave_gate(w)
            setattr(self, name, _frozen(w, device, dt))
            del w

        def vec(name):
            return _frozen(to_device(W[p + name + ".weight"], device,
                                     torch.float32), device)
        self.in_ln = vec("input_layernorm")
        self.post_ln = vec("post_attention_layernorm")
        self.q_norm = vec("self_attn.q_norm")
        self.k_norm = vec("self_attn.k_norm")

    def i8(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, name + "_codes"), getattr(self, name + "_scales")


def causal_keys(n: int) -> int:
    """Keys that the n real tokens of a sequence attend to: n(n + 1) / 2."""
    return n * (n + 1) // 2


class Qwen3Model(nn.Module):
    """Token ids -> (B, H) f32 unit vectors: the final norm of each row's
    last real token, L2-normalised (Qwen3-Embedding). Each layer's QKV and
    output projections are spans `encoder.proj` (args kind "qkv" or
    "out", B, S), its attention `encoder.attn` (args kind "causal", B, S,
    heads, kv_heads, and with the host's `lengths` the real tokens `real`
    and the keys they attend to `keys`) and its FFN `encoder.ffn` (B, S),
    while a capture runs."""

    pools = True  # forward returns the sentence embedding
    host_lengths = True  # the spans' real tokens and keys (forward)

    @staticmethod
    def token_flops(cfg: Qwen3Config) -> int:
        """Model FLOPs of one token's projections through every layer: 2
        a multiply-add over the QKV (q's nh heads, k's and v's nkv),
        output and SwiGLU (gate and up, then down) matrices."""
        H, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        nh, nkv = cfg.num_heads, cfg.num_kv_heads
        return 2 * cfg.num_layers * (H * (nh + 2 * nkv) * hd + nh * hd * H
                                     + 3 * H * I)

    def __init__(self, cfg: Qwen3Config, params: Params, *, device):
        super().__init__()
        self.cfg = cfg
        self.route = route(cfg, device)
        dev = torch.device(device)
        self.word = _frozen(to_device(params["embed_tokens.weight"], dev,
                                      cfg.dtype), dev, cfg.dtype)
        self.final_ln = _frozen(to_device(params["norm.weight"], dev,
                                          torch.float32), dev)
        self.layers = nn.ModuleList(
            Qwen3Layer(cfg, params, i, self.route, device=dev)
            for i in range(cfg.num_layers))
        self.rope = mb.rope_tables(cfg.max_position_embeddings,
                                   cfg.head_dim, cfg.rope_theta, dev)
        if self.route == "layer_i8":
            nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            self._zero = {n: torch.zeros(n, device=dev) for n in (
                (nh + 2 * nkv) * hd, cfg.hidden_size,
                2 * cfg.intermediate_size)}

    @property
    def device(self) -> torch.device:
        return self.word.device

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                mask_padding: bool = True, lengths=None) -> torch.Tensor:
        cfg = self.cfg
        B, S = input_ids.shape
        nh, nkv, eps, dt = (cfg.num_heads, cfg.num_kv_heads,
                            cfg.layer_norm_eps, cfg.dtype)
        if S > cfg.max_position_embeddings:
            raise ValueError(f"S={S} is past max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if attention_mask is None or not mask_padding:
            lens = torch.full((B,), S, dtype=torch.int32, device=self.device)
            lengths = None if lengths is None else np.full(B, S)
        else:
            lens = attention_mask.sum(dim=1, dtype=torch.int32)
        attn = {"kind": "causal", "B": B, "S": S, "heads": nh,
                "kv_heads": nkv}
        if lengths is not None:
            attn.update(real=int(np.sum(lengths)),
                        keys=sum(causal_keys(int(n)) for n in lengths))
        cos, sin = self.rope
        x, a, ssq = q3.embed(self.word, input_ids, self.layers[0].in_ln, dt)
        for i, layer in enumerate(self.layers):
            last = i == cfg.num_layers - 1
            nxt = self.final_ln if last else self.layers[i + 1].in_ln
            if self.route == "layer_i8":
                x = self._layer_i8(layer, x, lens, B, S, attn)
                continue
            with span("encoder.proj", kind="qkv", B=B, S=S):
                qkv = q3.qkv_norm_rope(a, ssq, layer.qkv_w, layer.q_norm,
                                       layer.k_norm, cos, sin, S, nh, nkv,
                                       eps)
            with span("encoder.attn", **attn):
                ctx = q3.attention(qkv, lens, B, S, nh, nkv)
            with span("encoder.proj", kind="out", B=B, S=S):
                h, m, sh = q3.resid_rms(ctx, layer.attn_out_w, x,
                                        layer.post_ln)
            with span("encoder.ffn", B=B, S=S):
                g = q3.swiglu(m, sh, layer.ffn_in_w, eps)
                x, a, ssq = q3.resid_rms(g, layer.ffn_out_w, h, nxt)
        return q3.last_pool(x, lens, S, self.final_ln, eps)

    def _mm8(self, a: torch.Tensor, w) -> torch.Tensor:
        """a · the (codes, scales) weight, W8A8 (K4's pieces), f32."""
        if not a.is_cuda:
            return _mm_i8(a.float(), *w)
        codes, rf = quant_rows(a.float())
        return _gemm_i8(codes, w, self._zero[w[0].shape[0]], 0,
                        dt=torch.bfloat16, rf=rf).float()

    def _layer_i8(self, layer, x, lens, B, S, attn):
        cfg = self.cfg
        nh, nkv, hd, eps = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.layer_norm_eps)
        cos, sin = self.rope
        with span("encoder.proj", kind="qkv", B=B, S=S):
            y = self._mm8(q3.rms_head(x, layer.in_ln, eps),
                          layer.i8("qkv_w")).view(B, S, nh + 2 * nkv, hd)
            q = q3.rms_head(y[:, :, :nh], layer.q_norm, eps)
            k = q3.rms_head(y[:, :, nh:nh + nkv], layer.k_norm, eps)
            qk = mb.rope_plain(torch.cat((q, k), dim=2), cos[:S], sin[:S])
            qkv = torch.cat((qk, y[:, :, nh + nkv:]), dim=2).reshape(B * S, -1)
        with span("encoder.attn", **attn):
            ctx = q3.attention(qkv.to(cfg.dtype), lens, B, S, nh, nkv)
        with span("encoder.proj", kind="out", B=B, S=S):
            h = x + self._mm8(ctx, layer.i8("attn_out_w"))
        with span("encoder.ffn", B=B, S=S):
            g, u = self._mm8(q3.rms_head(h, layer.post_ln, eps),
                             layer.i8("ffn_in_w")).chunk(2, dim=-1)
            x = h + self._mm8(torch.nn.functional.silu(g) * u,
                              layer.i8("ffn_out_w"))
        return x
