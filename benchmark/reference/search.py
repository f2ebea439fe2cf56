"""Exact search: the k best rows of an f32 store for f32 queries, by the
node's distance (1 - dot), TF32 off."""

from __future__ import annotations

import torch


@torch.no_grad()
def exact_topk(store: torch.Tensor, queries: torch.Tensor, k: int,
               block: int = 1 << 18) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) store, (B, D) queries -> ((B, k) distances ascending,
    (B, k) row ids), in blocks of `block` store rows."""
    best_d = best_i = None
    for s in range(0, store.shape[0], block):
        dots = queries @ store[s:s + block].T
        d, i = torch.topk(dots, min(k, dots.shape[1]), dim=1)
        d, i = 1.0 - d, i + s
        if best_d is not None:
            d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
            order = torch.argsort(d, dim=1, stable=True)[:, :k]
            d, i = d.gather(1, order), i.gather(1, order)
        best_d, best_i = d, i
    return best_d, best_i
