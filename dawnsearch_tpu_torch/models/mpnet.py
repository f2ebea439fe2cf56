"""MPNet encoder family (all-mpnet-base-v2 shape) on the shared layer stack.

Port of dawnsearch_tpu/models/mpnet.py. MPNet differs from BERT in three
ways (HF transformers' modeling_mpnet.py, the oracle the tests hold both
packages against):

1. Position ids are RoBERTa-style: `pad_id + cumsum(ids != pad)` for real
   tokens, `pad_id` for padding (pad_token_id = 1,
   max_position_embeddings = 514). There are no token-type embeddings.
2. Every layer's attention scores get one SHARED relative-position bias: a
   (num_buckets = 32, nh) learned table gathered through a bucketed (S, S)
   relative-distance matrix (T5's log-bucket scheme, max_distance = 128).
   It is gathered once per forward into (nh, S, S) f32 on the model's
   device and handed to every layer, where it rides into K1 or K4 as their
   `rel_bias` operand, or into the per-op path's einsum attention.
3. q/k/v/o are separate linears in the checkpoint; models/weights.py fuses
   them into BERT's qkv layout on import, so the layers are BertLayer.

The softmax, LayerNorm and GELU numerics, the post-LN residual order, the
masked mean-pool and the L2 normalize are the BERT path's (models/bert.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dawnsearch_tpu_torch.models.bert import (BertConfig, EncoderStack,
                                              Params, _frozen)

# sentence-transformers/all-mpnet-base-v2's config.json
MPNET_BASE = BertConfig(
    vocab_size=30527, hidden_size=768, num_layers=12, num_heads=12,
    intermediate_size=3072, max_position_embeddings=514, type_vocab_size=0,
    layer_norm_eps=1e-5, model_type="mpnet", pad_token_id=1)


@functools.lru_cache(maxsize=32)
def _bucket_matrix(S: int, num_buckets: int, max_distance: int = 128
                   ) -> np.ndarray:
    """(S, S) int32 bucket of each key's distance from its query, as HF's
    MPNetEncoder.relative_position_bucket computes it: half the buckets
    split by sign, half of the rest exact, the others log-spaced up to
    max_distance."""
    ctx = np.arange(S, dtype=np.int64)[:, None]
    mem = np.arange(S, dtype=np.int64)[None, :]
    n = ctx - mem  # == -(memory_position - context_position)
    half = num_buckets // 2
    ret = (n < 0).astype(np.int64) * half
    n = np.abs(n)
    max_exact = half // 2
    with np.errstate(divide="ignore"):
        val_if_large = max_exact + (
            np.log(np.maximum(n, 1) / max_exact)
            / np.log(max_distance / max_exact) * (half - max_exact)
        ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, half - 1)
    ret += np.where(n < max_exact, n, val_if_large)
    return ret.astype(np.int32)


@functools.lru_cache(maxsize=64)
def _bucket_index(S: int, num_buckets: int, device: torch.device
                  ) -> torch.Tensor:
    """_bucket_matrix as an int64 tensor on `device`, made once per (S,
    device): a forward then copies nothing from the host, so it can be
    captured in a CUDA graph."""
    return torch.from_numpy(_bucket_matrix(S, num_buckets)).to(device,
                                                                torch.int64)


def position_bias(rel_table: torch.Tensor, S: int, nh: int,
                  num_buckets: int) -> torch.Tensor:
    """(num_buckets, nh) learned table -> contiguous (nh, S, S) f32 score
    bias on the table's device."""
    if tuple(rel_table.shape) != (num_buckets, nh):
        raise ValueError(f"relative-position table {tuple(rel_table.shape)}, "
                         f"want ({num_buckets}, {nh})")
    bucket = _bucket_index(S, num_buckets, rel_table.device)
    return rel_table.float()[bucket].permute(2, 0, 1).contiguous()


def mpnet_position_ids(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """RoBERTa-offset position ids (HF create_position_ids_from_input_ids):
    real token i gets pad_id + its 1-based index among real tokens; padding
    stays at pad_id."""
    real = (input_ids != pad_id).long()
    return torch.cumsum(real, dim=1) * real + pad_id


class MPNetModel(EncoderStack):
    """Token ids -> (B, S, H) f32 last hidden state (HF MPNetModel, minus
    the unused pooler; reference mpnet_forward, mpnet.py:92-116); cast=False
    leaves it in the compute dtype. `params` is the stacked tree with the
    (num_buckets, nh) table at "rel_bias"."""

    def __init__(self, cfg: BertConfig, params: Params, *, device):
        super().__init__(cfg, params, device=device)
        self.rel_table = _frozen(params["rel_bias"], device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                mask_padding: bool = True, cast: bool = True) -> torch.Tensor:
        cfg = self.cfg
        pos = mpnet_position_ids(input_ids, cfg.pad_token_id)
        x = self.word[input_ids] + self.position[pos]
        pos_bias = position_bias(self.rel_table, input_ids.shape[1],
                                 cfg.num_heads,
                                 cfg.relative_attention_num_buckets)
        return self.encode_embeddings(x, attention_mask, mask_padding,
                                      pos_bias, cast=cast)
