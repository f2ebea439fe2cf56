"""Embedding vector primitives (port of dawnsearch_tpu/ops/vector.py).

Conventions of the reference (its src/search/vector.rs):
EM_LEN = 384 (vector.rs:26); the index orders by 1 - <q, x> on unit
vectors (search_provider.rs:35-42); normalization tolerance 0.01
(vector.rs:185-192). The byte casts are host-side numpy, used by the
SQLite store for embedding blobs.
"""

from __future__ import annotations

import numpy as np
import torch

EM_LEN = 384
MAX_VECTOR_DELTA = 0.01


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` (reference: vector.rs:194-197, batched)."""
    norm = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / norm.clamp_min(eps)


def layer_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of an f32 y, in f32 (mean and
    variance computed directly, as the reference, model.rs:68-105)."""
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def layer_norm_from_partials(y: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, eps: float) -> torch.Tensor:
    """`layer_norm` with its sums in the order of the GEMM ring's cluster
    LayerNorm epilogue (csrc/gemm.cuh): the row is cut into chunks of 128
    columns, one per CTA of the cluster, the last holding what is left (a
    ragged N: 312 = 128 + 128 + 56); the chunks' Σy, added in chunk order,
    give the mean, then the chunks' Σ(y - mean)², added likewise, the
    variance. Same two-pass LayerNorm, f32 sums in another order."""
    n = y.shape[-1]

    def chunk_sum(t):
        total = t[..., :128].sum(dim=-1)
        for c in range(128, n, 128):
            total = total + t[..., c:c + 128].sum(dim=-1)
        return total[..., None]
    mean = chunk_sum(y) / n
    d = y - mean
    var = chunk_sum(d.square()) / n
    return d * torch.rsqrt(var + eps) * scale.float() + bias.float()


def embedding_to_bytes(v: np.ndarray) -> bytes:
    """f32[D] -> little-endian bytes, validating normalization
    (reference vector.rs:207-212)."""
    v = np.asarray(v, dtype="<f4")
    _check_normalized_np(v)
    return v.tobytes()


def bytes_to_embedding(b: bytes, dim: int = EM_LEN) -> np.ndarray:
    """bytes -> f32[D], validating length and normalization
    (reference vector.rs:199-205)."""
    if len(b) != dim * 4:
        raise ValueError(f"expected {dim * 4} bytes, got {len(b)}")
    v = np.frombuffer(b, dtype="<f4").copy()
    _check_normalized_np(v)
    return v


def _check_normalized_np(v: np.ndarray) -> None:
    l = float(np.linalg.norm(v.astype(np.float64)))
    if not np.isfinite(l) or not (1.0 - MAX_VECTOR_DELTA < l < 1.0 + MAX_VECTOR_DELTA):
        raise ValueError(f"Vector is not normalized (length {l})")
