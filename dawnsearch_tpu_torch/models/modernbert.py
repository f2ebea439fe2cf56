"""ModernBERT encoder family (nomic-ai/modernbert-embed-base shape).

HF transformers' modeling_modernbert.py (Warner et al. 2024, arXiv
2412.13663) is the oracle; reference/modernbert_plain.py writes its
equations out in plain f32 torch, and the tests hold this model to both.
ModernBERT differs from the BERT family (models/bert.py) in every layer:

- no position embeddings: q and k are rotated by position (RoPE), with
  θ = global_rope_theta in global layers and local_rope_theta in local
  ones;
- layers i % global_attn_every_n_layers == 0 attend globally, the others
  to keys within local_attention // 2 positions (and, in both, to real
  keys only);
- pre-norm: x = x + attn(LNa(x)), x = x + ffn(LNm(x)), LNa_0 the
  identity, then a final norm; every LayerNorm has a scale and no bias;
  the linears have none either;
- the FFN is GeGLU: gelu(a) ⊙ g with (a, g) = chunk(x·Wi, 2).

A layer runs the kernels of ops/modernbert.py (route "layer", bf16, on a
card: four launches, the residual stream in f32 between them) or their
plain twins (any route on the CPU). layer_impl = "layer_i8" on a card is
the W8A8 form, the control of the benchmark's comparison: the four
projections on K4's s8 pieces (ops/layer.py::quant_rows, _gemm_i8 and
i8_weight; the activations quantized per row, the weights per column),
RoPE and the GeGLU in plain torch around them, the attention and the norms
as on the bf16 route. The pool is encode_batch's (K8 under pool_impl =
"fused").

Parameters are the stacked tree

    {"embeddings": {"word" (V, H), "ln_scale" (H,)},
     "layers": {"qkv_w" (L, H, 3H), "attn_out_w" (L, H, H),
                "attn_ln_scale" (L, H)  (row 0 unused: the identity),
                "ffn_in_w" (L, H, 2I), "ffn_out_w" (L, I, H),
                "ffn_ln_scale" (L, H)},
     "final_ln_scale" (H,)}

with (in, out) matrices, as the BERT family's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dawnsearch_tpu_torch.models.bert import BertConfig, Params, _frozen
from dawnsearch_tpu_torch.models.weights import params_from_numpy
from dawnsearch_tpu_torch.ops import modernbert as mb
from dawnsearch_tpu_torch.ops.ffn import erf_poly
from dawnsearch_tpu_torch.ops.layer import (_gemm_i8, _mm_i8, i8_weight,
                                            quant_rows)
from dawnsearch_tpu_torch.utils.logging import span

# nomic-ai/modernbert-embed-base's config.json (ModernBERT-base widths)
MODERNBERT_BASE = BertConfig(
    vocab_size=50368, hidden_size=768, num_layers=22, num_heads=12,
    intermediate_size=1152, max_position_embeddings=8192, type_vocab_size=0,
    layer_norm_eps=1e-5, model_type="modernbert", pad_token_id=50283)

MATRICES = ("qkv_w", "attn_out_w", "ffn_in_w", "ffn_out_w")
_HF = {"qkv_w": "attn.Wqkv", "attn_out_w": "attn.Wo", "ffn_in_w": "mlp.Wi",
       "ffn_out_w": "mlp.Wo"}


def config_from_hf(hf: dict, path: str) -> BertConfig:
    """A BertConfig of model_type "modernbert" from its config.json;
    refuses what this port does not compute (biases, another activation,
    a head dim other than the kernels')."""
    for key in ("attention_bias", "mlp_bias", "norm_bias"):
        if hf.get(key, False):
            raise ValueError(f"{path}: {key} = true: the port serves "
                             "ModernBERT without biases, as published")
    act = hf.get("hidden_activation", "gelu")
    if act != "gelu":
        raise ValueError(f"{path}: hidden_activation={act!r} is not "
                         "supported (this encoder computes erf gelu)")
    return BertConfig(
        vocab_size=hf.get("vocab_size", 50368),
        hidden_size=hf.get("hidden_size", 768),
        num_layers=hf.get("num_hidden_layers", 22),
        num_heads=hf.get("num_attention_heads", 12),
        intermediate_size=hf.get("intermediate_size", 1152),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        type_vocab_size=0, layer_norm_eps=hf.get("norm_eps", 1e-5),
        model_type="modernbert", pad_token_id=hf.get("pad_token_id", 50283),
        global_attn_every_n_layers=hf.get("global_attn_every_n_layers", 3),
        local_attention=hf.get("local_attention", 128),
        global_rope_theta=float(hf.get("global_rope_theta", 160000.0)),
        local_rope_theta=float(hf.get("local_rope_theta", 10000.0)))


def from_hf_tensors(tensors, cfg: BertConfig) -> Params:
    """HF ModernBertModel tensors (numpy, names with or without the
    `model.` prefix) -> the stacked tree of f32 tensors."""
    t = {k[len("model."):] if k.startswith("model.") else k: v
         for k, v in tensors.items()}

    def get(name: str) -> np.ndarray:
        if name not in t:
            raise KeyError(f"missing tensor {name!r}; have {sorted(t)[:8]}...")
        return np.asarray(t[name], dtype=np.float32)

    H, L = cfg.hidden_size, cfg.num_layers
    layers: dict[str, list] = {k: [] for k in (
        *MATRICES, "attn_ln_scale", "ffn_ln_scale")}
    for i in range(L):
        p = f"layers.{i}."
        for name, hf in _HF.items():
            layers[name].append(get(p + hf + ".weight").T)
        layers["attn_ln_scale"].append(
            get(p + "attn_norm.weight") if i else np.ones(H, np.float32))
        layers["ffn_ln_scale"].append(get(p + "mlp_norm.weight"))
    if any(k.startswith(f"layers.{L}.") for k in t):
        raise ValueError(f"checkpoint has layers beyond the configured {L}; "
                         "put the model's real config.json next to "
                         "model.safetensors")
    tree = {"embeddings": {"word": get("embeddings.tok_embeddings.weight"),
                           "ln_scale": get("embeddings.norm.weight")},
            "layers": {k: np.stack(v) for k, v in layers.items()},
            "final_ln_scale": get("final_norm.weight")}
    return params_from_numpy(tree)


def init_params(generator: torch.Generator, cfg: BertConfig) -> Params:
    """Seeded random weights (normal, std 0.02; norm scales 1)."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape):
        return torch.randn(shape, generator=generator) * 0.02
    return {"embeddings": {"word": w(cfg.vocab_size, H),
                           "ln_scale": torch.ones(H)},
            "layers": {"qkv_w": w(L, H, 3 * H), "attn_out_w": w(L, H, H),
                       "attn_ln_scale": torch.ones(L, H),
                       "ffn_in_w": w(L, H, 2 * I), "ffn_out_w": w(L, I, H),
                       "ffn_ln_scale": torch.ones(L, H)},
            "final_ln_scale": torch.ones(H)}


def route(cfg: BertConfig, device) -> str:
    """"plain" (the twins: the CPU, any layer_impl), "layer" (the bf16
    kernels) or "layer_i8" (the W8A8 control) on a card."""
    if torch.device(device).type != "cuda":
        return "plain"
    if cfg.layer_impl not in ("layer", "layer_i8"):
        raise ValueError(f"ModernBERT on a card runs layer_impl 'layer' or "
                         f"'layer_i8', not {cfg.layer_impl!r}")
    if cfg.dtype != torch.bfloat16:
        raise ValueError("ModernBERT on a card runs compute_dtype 'bf16' "
                         "only")
    return cfg.layer_impl


class ModernBertLayer(nn.Module):
    """One layer's weights in the form its route reads: the compute
    dtype (Wi interleaved on the kernel route), or K4's (codes, scales)
    pairs."""

    def __init__(self, cfg: BertConfig, layer: Params, rt: str, *, device):
        super().__init__()
        for name in MATRICES:
            w = torch.as_tensor(layer[name]).float()
            if rt == "layer_i8":
                codes, scales = i8_weight(w)
                setattr(self, name + "_codes", _frozen(codes, device,
                                                       torch.int8))
                setattr(self, name + "_scales", _frozen(scales, device))
                continue
            if rt == "layer" and name == "ffn_in_w":
                w = mb.interleave_gate(w)
            setattr(self, name, _frozen(w, device, cfg.dtype))
        self.attn_ln = _frozen(layer["attn_ln_scale"], device)
        self.ffn_ln = _frozen(layer["ffn_ln_scale"], device)

    def i8(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, name + "_codes"), getattr(self, name + "_scales")


class ModernBertModel(nn.Module):
    """Token ids -> (B, S, H) f32 last hidden state (after the final
    norm; HF ModernBertModel). Each layer's attention is a span
    `encoder.attn` (args kind, B, S, window, theta, and with the host's
    `lengths` the real tokens `real` and the keys they attend to `keys`)
    and its FFN `encoder.ffn` (B, S), while a capture runs."""

    pools = False  # encode_batch mean-pools (K8) the last hidden state
    host_lengths = True  # the spans' real tokens and keys (forward)

    @staticmethod
    def token_flops(cfg: BertConfig) -> int:
        """Model FLOPs of one token's projections through every layer:
        QKV, output and the gated FFN (GeGLU's Wi is 2·I wide)."""
        H, I = cfg.hidden_size, cfg.intermediate_size
        return 2 * cfg.num_layers * (4 * H * H + 3 * H * I)

    def __init__(self, cfg: BertConfig, params: Params, *, device):
        super().__init__()
        self.cfg = cfg
        self.route = route(cfg, device)
        emb = params["embeddings"]
        self.word = _frozen(emb["word"], device)
        self.emb_ln = _frozen(emb["ln_scale"], device)
        self.final_ln = _frozen(params["final_ln_scale"], device)
        layers = params["layers"]
        self.layers = nn.ModuleList(
            ModernBertLayer(cfg, {k: v[i] for k, v in layers.items()},
                            self.route, device=device)
            for i in range(cfg.num_layers))
        hd = cfg.head_dim
        self.rope = {glob: mb.rope_tables(cfg.max_position_embeddings, hd,
                                          theta, self.word.device)
                     for glob, theta in ((True, cfg.global_rope_theta),
                                         (False, cfg.local_rope_theta))}
        if self.route == "layer_i8":
            self._zero = {n: torch.zeros(n, device=self.word.device)
                          for n in (3 * cfg.hidden_size, cfg.hidden_size,
                                    2 * cfg.intermediate_size)}

    @property
    def device(self) -> torch.device:
        return self.word.device

    def is_global(self, i: int) -> bool:
        return i % self.cfg.global_attn_every_n_layers == 0

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                mask_padding: bool = True, cast: bool = True,
                lengths=None) -> torch.Tensor:
        cfg = self.cfg
        B, S = input_ids.shape
        H, eps, dt = cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype
        if S > cfg.max_position_embeddings:
            raise ValueError(f"S={S} is past max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if attention_mask is None or not mask_padding:
            lens = torch.full((B,), S, dtype=torch.int32, device=self.device)
            lengths = None if lengths is None else np.full(B, S)
        else:
            lens = attention_mask.sum(dim=1, dtype=torch.int32)
        x, a = mb.embed_ln(self.word, input_ids, self.emb_ln, eps, dt)
        keys: dict = {}
        for i, layer in enumerate(self.layers):
            glob = self.is_global(i)
            window = None if glob else cfg.local_attention // 2
            last = i == cfg.num_layers - 1
            nxt = self.final_ln if last else self.layers[i + 1].attn_ln
            out_dt = torch.float32 if last else dt
            args = {"kind": "global" if glob else "local", "B": B, "S": S,
                    "window": -1 if glob else window,
                    "theta": cfg.global_rope_theta if glob
                    else cfg.local_rope_theta}
            if lengths is not None:
                if glob not in keys:
                    keys[glob] = sum(mb.band_keys(int(n), window)
                                     for n in lengths)
                args.update(real=int(np.sum(lengths)), keys=keys[glob])
            cos, sin = self.rope[glob]
            if self.route == "layer_i8":
                x, a = self._layer_i8(layer, x, a, lens, B, S, window, cos,
                                      sin, nxt, out_dt, args)
                continue
            qkv = mb.qkv_rope(a, layer.qkv_w, cos, sin, S, cfg.num_heads)
            with span("encoder.attn", **args):
                ctx = mb.attention(qkv, lens, B, S, cfg.num_heads, window)
            h, m = mb.resid_ln(ctx, layer.attn_out_w, x, layer.ffn_ln, eps,
                               dt)
            with span("encoder.ffn", B=B, S=S):
                g = mb.geglu(m, layer.ffn_in_w)
                x, a = mb.resid_ln(g, layer.ffn_out_w, h, nxt, eps, out_dt)
        return a.view(B, S, H)

    def _mm8(self, a: torch.Tensor, w) -> torch.Tensor:
        """a · the (codes, scales) weight, W8A8 (K4's pieces), f32."""
        if not a.is_cuda:
            return _mm_i8(a.float(), *w)
        codes, rf = quant_rows(a.float())
        return _gemm_i8(codes, w, self._zero[w[0].shape[0]], 0,
                        dt=torch.bfloat16, rf=rf).float()

    def _layer_i8(self, layer, x, a, lens, B, S, window, cos, sin, nxt,
                  out_dt, args):
        cfg = self.cfg
        nh, hd, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
        y = self._mm8(a, layer.i8("qkv_w")).view(B, S, 3, nh, hd)
        qk = mb.rope_plain(y[:, :, :2].reshape(B, S, 2 * nh, hd), cos[:S],
                           sin[:S]).view(B, S, 2, nh, hd)
        qkv = torch.cat((qk, y[:, :, 2:]), dim=2).reshape(B * S, -1)
        with span("encoder.attn", **args):
            ctx = mb.attention(qkv.to(cfg.dtype), lens, B, S, nh, window)
        h = x + self._mm8(ctx, layer.i8("attn_out_w"))
        with span("encoder.ffn", B=B, S=S):
            m = mb.scale_ln(h, layer.ffn_ln, eps)
            g_in, g_gate = self._mm8(m, layer.i8("ffn_in_w")).chunk(2, dim=-1)
            g = 0.5 * g_in * (1.0 + erf_poly(g_in * 2.0 ** -0.5)) * g_gate
            x = h + self._mm8(g, layer.i8("ffn_out_w"))
        return x, mb.scale_ln(x, nxt, eps).to(out_dt)
