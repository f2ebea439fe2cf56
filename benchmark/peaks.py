"""The yardstick's numbers: the card's published peaks and the operations
and bytes the measured work needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16, 3.35 TB/s HBM. A share is stated against them,
with the card's power limit printed beside it.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def encoder_flops(n_tokens: int, config: dict) -> int:
    """Model operations of one text of n real tokens through the encoder:
    2·n·L·(4H² + 2HI) for the projections and 4·n²·H·L for the scores and
    the weighted sum (chip_smoke.py's layer_flops, per text)."""
    H, I = config["hidden_size"], config["intermediate_size"]
    L = config["num_hidden_layers"]
    return 2 * n_tokens * L * (4 * H * H + 2 * H * I) \
        + 4 * n_tokens * n_tokens * H * L


def select_bytes(rows: int, dim: int) -> int:
    """Bytes one i8 select launch must read: each live row's codes and its
    f32 scale (the queries are a rounding error)."""
    return rows * (dim + 4)
