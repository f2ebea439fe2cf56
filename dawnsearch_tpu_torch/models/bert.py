"""BERT sentence encoder (all-MiniLM-L6-v2 shape) as a torch module.

Port of dawnsearch_tpu/models/bert.py: embeddings + LayerNorm
(bert.py:232-251), the layer stack, mean-pool and L2 normalize
(bert.py:275-325). The RoBERTa family (model_type "roberta") is this
model with offset position ids (bert.py:234-240). The layer stack is
shared with the MPNet family (models/mpnet.py), which adds one (nh, S, S) relative-position score bias
to every layer (`pos_bias`). A layer runs one of the reference's paths,
routed condition for condition as `_layer_fwd` does (bert.py:125-126,
:139, :180-195):

- a whole-layer kernel (ops/layer.py) when attn_impl is not "xla" and the
  width fits the packed envelope (128 % head_dim == 0, H % 128 == 0): K1
  for layer_impl="layer", K4 (W8A8 projections) for layer_impl="layer_i8";
  MPNet's pos_bias rides into either as its `rel_bias` operand;
- otherwise the per-op path: the QKV projection, attention (packed K5 in
  the envelope, head-major K6 outside it, both ops/attention.py; einsum
  attention for attn_impl="xla" and, as in the reference, whenever a
  pos_bias is set, which K5 and K6 do not take), the output projection, a
  residual add in the compute dtype with a LayerNorm, and the fused FFN
  (ops/ffn.py, K7).

The reference's ffn_impl="xla" (two dense calls, bert.py:199-213) is set
only by its tests and no node setting reaches it, so it is not carried.

pool_impl="fused" pools and normalizes with K8 (ops/attention.py), which
reads the last hidden state in the compute dtype and the int32 mask as
they are, with no cast launch before it. The reference's parity flags
stay: `mask_padding=False` attends over padding like the reference model
(model.rs:325-347) and `include_padding=True` pools over it
(embedding_service.rs:126-128). The key mask is an additive
-1e30 bias (bert.py:254-257).

Parameters never require gradients; encode_batch runs under
torch.inference_mode(). Matrices are stored in the compute dtype, biases,
LayerNorm parameters and embeddings in f32, as the reference casts them.
A layer on K4's route stores its matrices only as i8 codes, (out, in) as
K4's s8 wgmma reads them, and f32 per-column scales, quantized once from
the f32 parameters (the reference quantizes the same f32 matrices on
every call, ops/layer.py:344-347). At f32 on a card, a layer stores each
matrix a 3xTF32 GEMM reads only as its (W_hi, W_lo) pair
(ops/layer.py::tf32_pair), made once here: on K1's route all four, on the
per-op route the two FFN matrices K7 reads (the QKV and output
projections stay f32 for torch's matmul). Each pair takes twice its
matrix's f32 memory.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from dawnsearch_tpu_torch.ops.attention import (fused_attention,
                                                fused_attention_packed,
                                                fused_mean_pool)
from dawnsearch_tpu_torch.ops.ffn import fused_ffn
from dawnsearch_tpu_torch.ops.layer import (fused_bert_layer,
                                            fused_bert_layer_i8, i8_weight,
                                            tf32_pair)
from dawnsearch_tpu_torch.ops.vector import layer_norm, normalize

Params = dict


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # "bert" | "roberta" | "mpnet": roberta takes offset position ids;
    # mpnet (models/mpnet.py) also drops token types and adds the shared
    # relative-position score bias; the layer stack is the same;
    # "modernbert" is a family of its own (models/modernbert.py)
    model_type: str = "bert"
    # the vocab's pad id (config.json; mpnet and roberta checkpoints use 1,
    # from which their position ids are offset); the node checks its
    # tokenizer's
    pad_token_id: int = 0
    relative_attention_num_buckets: int = 32  # mpnet only
    # modernbert only (models/modernbert.py): every n-th layer from 0 is
    # global, the others attend within local_attention // 2 positions;
    # rotary positions with each kind's θ
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    # compute dtype of the projections; softmax and LayerNorm stay f32
    dtype: torch.dtype = torch.float32
    # "fused" = K5 (packed) or K6 attention kernels; "xla" = einsum attention
    attn_impl: str = "fused"
    # "xla" = plain mean-pool + normalize; "fused" = K8
    pool_impl: str = "xla"
    # "layer" = the whole-layer kernel K1 where the width fits; "layer_i8" =
    # K4, the same layer with W8A8 projections; "ops" = the per-op kernels
    # above (also the fallback outside the envelope)
    layer_impl: str = "layer"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


MINILM_L6 = BertConfig()


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm in f32, cast back to x's dtype (bert.py:91-98)."""
    return layer_norm(x.float(), scale, bias, eps).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """x·w + b rounded once to `dtype` (bert.py:101-103): an f32 product of
    compute-dtype operands plus the f32 bias. On the card the product
    is a bf16 tensor-core GEMM with f32 output, or at f32 torch's f32
    GEMM, which takes true f32 products while
    torch.backends.cuda.matmul.allow_tf32 keeps its default, False (the
    port never sets it)."""
    x2d = x.reshape(-1, x.shape[-1]).to(dtype)
    if x2d.is_cuda and dtype != torch.float32:
        y = torch.mm(x2d, w.to(dtype), out_dtype=torch.float32)
    else:
        y = x2d.float() @ w.to(dtype).float()
    return (y + b.float()).to(dtype).reshape(*x.shape[:-1], w.shape[-1])


def _packed(cfg: BertConfig) -> bool:
    """The width fits the reference's packed-lane envelope."""
    return 128 % cfg.head_dim == 0 and cfg.hidden_size % 128 == 0


def layer_route(cfg: BertConfig) -> str:
    """The path every layer of `cfg` takes: "layer" (K1), "layer_i8" (K4)
    or "ops" (bert.py:180-181)."""
    if (cfg.layer_impl in ("layer", "layer_i8") and cfg.attn_impl != "xla"
            and _packed(cfg)):
        return cfg.layer_impl
    return "ops"


def _attention(x: torch.Tensor, layer: "BertLayer", cfg: BertConfig,
               bias: torch.Tensor | None,
               pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head self-attention (bert.py:106-165) through one fused QKV
    projection. bias: (B, S) f32 additive key bias or None; pos_bias: the
    (nh, S, S) f32 score bias of every layer (MPNet) or None, which sends
    attention to the einsum path, as in the reference."""
    B, S, H = x.shape
    nh, hd, dt = cfg.num_heads, cfg.head_dim, cfg.dtype
    qkv = _dense(x, layer.qkv_w, layer.qkv_b, dt)      # (B, S, 3H)
    q, k, v = qkv.split(H, dim=-1)
    kernel = cfg.attn_impl == "fused" and pos_bias is None
    if kernel and _packed(cfg):
        ctx = fused_attention_packed(q, k, v, bias, nh=nh)
        return _dense(ctx.to(dt), layer.attn_out_w, layer.attn_out_b, dt)
    q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2) for t in (q, k, v))
    if kernel:
        ctx = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              bias, nh=nh).to(dt)
    else:
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        if pos_bias is not None:
            scores = scores + pos_bias[None]
        if bias is not None:
            scores = scores + bias.float()[:, None, None, :]
        if dt == torch.bfloat16:
            # the reference rounds the scores and s - max to bf16 and runs
            # exp and the normalisation in f32 (bert.py:151-159)
            s16 = scores.to(torch.bfloat16)
            e = torch.exp((s16 - s16.amax(dim=-1, keepdim=True)).float())
            probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
        else:
            probs = torch.softmax(scores, dim=-1).to(dt)
        ctx = (probs.float() @ v.float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(B, S, H)
    return _dense(ctx, layer.attn_out_w, layer.attn_out_b, dt)


def _layer_fwd(x: torch.Tensor, layer: "BertLayer", cfg: BertConfig,
               bias: torch.Tensor | None,
               pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """One post-LN layer (bert.py:168-215) on the route the config and
    width pick; pos_bias rides into K1 or K4 as rel_bias."""
    route = layer_route(cfg)
    if route == "layer_i8":
        i8 = layer.i8
        return fused_bert_layer_i8(
            x.to(cfg.dtype), bias, i8("qkv_w"), layer.qkv_b, i8("attn_out_w"),
            layer.attn_out_b, layer.attn_ln_scale, layer.attn_ln_bias,
            i8("ffn_in_w"), layer.ffn_in_b, i8("ffn_out_w"), layer.ffn_out_b,
            layer.ffn_ln_scale, layer.ffn_ln_bias, nh=cfg.num_heads,
            eps=cfg.layer_norm_eps, rel_bias=pos_bias)
    mat = layer.matrix
    if route == "layer":
        return fused_bert_layer(
            x.to(cfg.dtype), bias, mat("qkv_w"), layer.qkv_b,
            mat("attn_out_w"), layer.attn_out_b, layer.attn_ln_scale,
            layer.attn_ln_bias, mat("ffn_in_w"), layer.ffn_in_b,
            mat("ffn_out_w"), layer.ffn_out_b,
            layer.ffn_ln_scale, layer.ffn_ln_bias, nh=cfg.num_heads,
            eps=cfg.layer_norm_eps, rel_bias=pos_bias)
    attn = _attention(x, layer, cfg, bias, pos_bias)
    x = _layer_norm(x + attn, layer.attn_ln_scale, layer.attn_ln_bias,
                    cfg.layer_norm_eps)
    B, S, H = x.shape
    y = fused_ffn(x.reshape(B * S, H).to(cfg.dtype), mat("ffn_in_w"),
                  layer.ffn_in_b, mat("ffn_out_w"), layer.ffn_out_b,
                  layer.ffn_ln_scale, layer.ffn_ln_bias, eps=cfg.layer_norm_eps)
    return y.reshape(B, S, H)


def _frozen(t, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(t).to(device=device, dtype=dtype)
                        .contiguous(), requires_grad=False)


class BertLayer(nn.Module):
    """One post-LN layer's weights; forward is `_layer_fwd`. On K4's route
    each matrix `m` is held only as `m_codes` (i8, laid out (out, in) by
    i8_weight) and `m_scales` (f32 per column); at f32 on a card, on K1's
    route and for K7's two matrices on the per-op route, only as `m_hi`
    and `m_lo` (tf32_pair); otherwise in the compute dtype."""

    MATRICES = ("qkv_w", "attn_out_w", "ffn_in_w", "ffn_out_w")
    VECTORS = ("qkv_b", "attn_out_b", "attn_ln_scale", "attn_ln_bias",
               "ffn_in_b", "ffn_out_b", "ffn_ln_scale", "ffn_ln_bias")

    def __init__(self, cfg: BertConfig, layer: Params, *, device):
        super().__init__()
        self.cfg = cfg
        route = layer_route(cfg)
        paired = ()
        if cfg.dtype == torch.float32 and torch.device(device).type == "cuda":
            paired = {"layer": self.MATRICES,
                      "ops": ("ffn_in_w", "ffn_out_w")}.get(route, ())
        for name in self.MATRICES:
            if route == "layer_i8":
                codes, scales = i8_weight(torch.as_tensor(layer[name]).float())
                setattr(self, name + "_codes", _frozen(codes, device, torch.int8))
                setattr(self, name + "_scales", _frozen(scales, device))
            elif name in paired:
                pair = tf32_pair(torch.as_tensor(layer[name]).to(device))
                for part, t in zip(("_hi", "_lo"), pair):
                    setattr(self, name + part, _frozen(t, device))
            else:
                setattr(self, name, _frozen(layer[name], device, cfg.dtype))
        for name in self.VECTORS:
            setattr(self, name, _frozen(layer[name], device))

    def i8(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Matrix `name` as K4 takes it: (i8 codes (N, K), f32 scales)."""
        return getattr(self, name + "_codes"), getattr(self, name + "_scales")

    def matrix(self, name: str):
        """Matrix `name` as K1 and K7 take it: (W_hi, W_lo) where the
        layer holds the pair, else the matrix."""
        if hasattr(self, name + "_hi"):
            return getattr(self, name + "_hi"), getattr(self, name + "_lo")
        return getattr(self, name)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None,
                pos_bias: torch.Tensor | None = None) -> torch.Tensor:
        return _layer_fwd(x, self, self.cfg, bias, pos_bias)


class EncoderStack(nn.Module):
    """What the BERT and MPNet families share (bert.py:261-272): word
    and position embeddings, the embedding LayerNorm and the layer stack.
    `params` is the reference's stacked tree (models/weights.py), each leaf
    a tensor or array."""

    # what SentenceEncoder reads of a family: forward returns the last
    # hidden state (encode_batch pools it), not the sentence embedding;
    # its spans need no real lengths from the host
    pools = False
    host_lengths = False

    @staticmethod
    def token_flops(cfg: BertConfig) -> int:
        """Model FLOPs of one token's projections through every layer: 2
        a multiply-add over the QKV, output and two FFN matrices."""
        H, I = cfg.hidden_size, cfg.intermediate_size
        return 2 * cfg.num_layers * (4 * H * H + 2 * H * I)

    def __init__(self, cfg: BertConfig, params: Params, *, device):
        super().__init__()
        self.cfg = cfg
        emb = params["embeddings"]
        self.word = _frozen(emb["word"], device)
        self.position = _frozen(emb["position"], device)
        self.emb_ln_scale = _frozen(emb["ln_scale"], device)
        self.emb_ln_bias = _frozen(emb["ln_bias"], device)
        layers = params["layers"]
        self.layers = nn.ModuleList(
            BertLayer(cfg, {k: v[i] for k, v in layers.items()}, device=device)
            for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.word.device

    def encode_embeddings(self, x: torch.Tensor,
                          attention_mask: torch.Tensor | None,
                          mask_padding: bool,
                          pos_bias: torch.Tensor | None = None,
                          cast: bool = True) -> torch.Tensor:
        """Summed (B, S, H) f32 embeddings -> LayerNorm -> every layer ->
        (B, S, H) last hidden state: f32, or with cast=False in the
        compute dtype (encode_batch's K8 route, which reads it as it is)."""
        x = _layer_norm(x, self.emb_ln_scale, self.emb_ln_bias,
                        self.cfg.layer_norm_eps).to(self.cfg.dtype)
        bias = None
        if mask_padding and attention_mask is not None:
            bias = torch.where(attention_mask.bool(), 0.0, -1e30).float()
        for layer in self.layers:
            x = layer(x, bias, pos_bias)
        return x.float() if cast else x


class BertModel(EncoderStack):
    """Token ids -> (B, S, H) f32 last hidden state (reference
    BertModel::forward, model.rs:528-571, and bert_forward, bert.py:218-258,
    for the bert and roberta families); cast=False leaves it in the compute
    dtype."""

    def __init__(self, cfg: BertConfig, params: Params, *, device):
        super().__init__(cfg, params, device=device)
        self.token_type = _frozen(params["embeddings"]["token_type"], device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                mask_padding: bool = True, cast: bool = True) -> torch.Tensor:
        if self.cfg.model_type == "roberta":
            # RoBERTa's positions are offset from the pad id and padding
            # sits at it (HF create_position_ids_from_input_ids), as MPNet's
            from dawnsearch_tpu_torch.models.mpnet import mpnet_position_ids
            pos = self.position[mpnet_position_ids(input_ids,
                                                   self.cfg.pad_token_id)]
        else:
            S = input_ids.shape[1]
            pos = self.position[torch.arange(S, device=input_ids.device)][None]
        x = self.word[input_ids] + pos + self.token_type[0]
        return self.encode_embeddings(x, attention_mask, mask_padding,
                                      cast=cast)


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor | None = None,
              include_padding: bool = False) -> torch.Tensor:
    """Mean-pool token states -> (B, H). Default: masked mean like
    sentence-transformers; include_padding=True pools over everything
    (embedding_service.rs:126-128)."""
    if include_padding or attention_mask is None:
        return hidden.mean(dim=1)
    m = attention_mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


@torch.inference_mode()
def encode_batch(model: EncoderStack, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, mask_padding: bool = True,
                 include_padding: bool = False, **model_args) -> torch.Tensor:
    """Sentence embeddings: BERT or MPNet -> mean-pool -> L2 normalize,
    (B, H) f32 on the model's device (reference calculate_embedding,
    embedding_service.rs:97-139, minus tokenization). The model's class
    carries its family (the reference routes on cfg.model_type,
    bert.py:312-318); the pool follows the model's pool_impl. K8 reads
    the last hidden state in the compute dtype (the reference casts it to
    f32 first, and K8's bf16 -> f32 conversion is exact). `model_args`
    go to the model (ModernBERT's host `lengths`)."""
    fused = model.cfg.pool_impl == "fused"
    hidden = model(input_ids, attention_mask, mask_padding=mask_padding,
                   cast=not fused, **model_args)
    if fused:
        return fused_mean_pool(hidden, attention_mask,
                               include_padding=include_padding)
    pooled = mean_pool(hidden, attention_mask, include_padding=include_padding)
    return normalize(pooled, eps=1e-12)
