"""i4 storage quantization (the index's capacity tier, 0.5 byte/dim) and
the i24 and i8 wire codecs of the P2P packets.

Port of the i4 half of dawnsearch_tpu/ops/quant.py, with the same layout
so snapshots cross between the packages.

ROW-BLOCK nibble packing. Codes live as uint8 (capacity/2, D): within each
block of `block` logical rows, packed row p holds dim j of logical row p
in the LOW nibble and of logical row p + block/2 in the HIGH nibble.
Unpacking a whole block yields its rows in natural order ([lo rows | hi
rows]), so the fused selector's window ids, per-row scales and count mask
are those of the i8 tier (one block = one 16,384-row selector tile).
Codes are symmetric [-7, 7] with a per-row scale absmax/7, stored biased
+8 in [1, 15]; scales stay per logical row.

The host helpers work on numpy (a host add packs whole blocks before the
copy to the device); the device helpers work on tensors, and
`write_rows_i4` writes into the preallocated buffer in place.

The wire codecs (to_i24_bytes / from_i24_bytes, to_i8_wire_bytes /
from_i8_wire_bytes) are copies of dawnsearch_tpu/ops/quant.py:42-106,
numpy only: net/packets.py ships query embeddings with them, byte for
byte as the reference does (the reference's src/search/vector.rs:48-87
for i24).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from dawnsearch_tpu_torch.ops.vector import EM_LEN, MAX_VECTOR_DELTA

# One packing block = one fused-selector tile (scan_select.DEFAULT_TN).
# Indexes whose segment is not a multiple of this use block = segment and
# serve from the chunked path only.
I4_BLOCK = 16384


def quantize_i4_vals_np(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) f32 -> ((N, D) uint8 biased nibble values in [1, 15],
    (N,) f32 scales). Rounds half to even (np.rint)."""
    rows = np.atleast_2d(np.asarray(rows, np.float32))
    if rows.shape[1] % 2:
        raise ValueError(f"i4 packing needs an even dim, got {rows.shape[1]}")
    absmax = np.abs(rows).max(axis=1)
    scales = (np.maximum(absmax, 1e-12) / 7.0).astype(np.float32)
    vals = (np.clip(np.rint(rows / scales[:, None]), -7, 7)
            .astype(np.int16) + 8).astype(np.uint8)
    return vals, scales


def quantize_i4_vals(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of quantize_i4_vals_np (torch.round is half to even)."""
    rows = torch.atleast_2d(rows).float()
    scales = rows.abs().amax(dim=1).clamp_min(1e-12) / 7.0
    vals = torch.round(rows / scales[:, None]).clamp(-7, 7) + 8
    return vals.to(torch.uint8), scales


def pack_i4_np(vals: np.ndarray, block: int = I4_BLOCK) -> np.ndarray:
    """(N, D) biased nibble values -> (N/2, D) row-block packed uint8.
    N must be a multiple of `block`."""
    n, d = vals.shape
    if block % 2 or n % block:
        raise ValueError(f"pack_i4 needs n % block == 0 and even block, "
                         f"got n={n} block={block}")
    g = vals.reshape(n // block, block, d)
    return (g[:, : block // 2] | (g[:, block // 2:] << 4)).reshape(
        n // 2, d).astype(np.uint8)


def unpack_i4_np(packed: np.ndarray, block: int = I4_BLOCK) -> np.ndarray:
    """(P, D) row-block packed uint8 -> (2P, D) int8 codes in [-7, 7],
    natural row order. 2P must be a multiple of `block`."""
    p = np.asarray(packed, np.uint8)
    n, d = 2 * p.shape[0], p.shape[1]
    if n % block:
        raise ValueError(f"unpack_i4 needs rows % block == 0, "
                         f"got {n} rows, block={block}")
    g = p.reshape(n // block, block // 2, d)
    lo = (g & 0xF).astype(np.int8) - 8
    hi = (g >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1).reshape(n, d)


def unpack_i4_vals(packed: torch.Tensor, block: int = I4_BLOCK) -> torch.Tensor:
    """(P, D) packed -> (2P, D) uint8 biased nibble values, natural row
    order (what quantize_i4_vals made and write_rows_i4 takes)."""
    n, d = 2 * packed.shape[0], packed.shape[1]
    g = packed.reshape(n // block, block // 2, d)
    return torch.cat([g & 0xF, g >> 4], dim=1).reshape(n, d)


def _pack(vals: torch.Tensor, block: int) -> torch.Tensor:
    n, d = vals.shape
    g = vals.reshape(n // block, block, d)
    return (g[:, : block // 2] | (g[:, block // 2:] << 4)).reshape(n // 2, d)


def unpack_i4(packed: torch.Tensor, block: int = I4_BLOCK) -> torch.Tensor:
    """Tensor twin of unpack_i4_np -> (2P, D) int8 codes."""
    if (2 * packed.shape[0]) % block:
        raise ValueError(f"unpack_i4 needs rows % block == 0, got "
                         f"{2 * packed.shape[0]} rows, block={block}")
    return unpack_i4_vals(packed, block).to(torch.int8) - 8


def write_rows_i4(buf: torch.Tensor, vals: torch.Tensor, start: int,
                  block: int = I4_BLOCK) -> None:
    """Write `vals` ((n, D) biased nibble values) at LOGICAL row `start`
    into the row-block packed `buf` ((capP, D) uint8) in place. Reads the
    block-aligned region that covers the write, unpacks it, updates,
    repacks and writes it back: nibble writes share bytes with rows that
    already landed. The region is the reference's (n // block + 2 blocks,
    clipped to the buffer), so both packages touch the same bytes."""
    capL = 2 * buf.shape[0]
    n = vals.shape[0]
    if start < 0 or start + n > capL:
        raise ValueError(f"write_rows_i4: rows [{start}, {start + n}) "
                         f"outside the buffer's {capL}")
    RL = min(n // block + 2, capL // block) * block
    r0 = min(max((start // block) * block, 0), capL - RL)
    if start + n > r0 + RL:
        raise ValueError("write_rows_i4: the write straddles more blocks "
                         "than its region")
    region = buf[r0 // 2:(r0 + RL) // 2]
    logical = unpack_i4_vals(region, block)
    logical[start - r0:start - r0 + n] = vals.to(torch.uint8)
    region.copy_(_pack(logical, block))


def i4_block_for(segment: int) -> int:
    """The packing block of an index with this segment size: the selector
    tile when the segment aligns to it (every grown capacity then stays
    block-aligned), else the segment itself (small indexes, chunked path
    only)."""
    if segment % I4_BLOCK == 0:
        return I4_BLOCK
    if segment % 2:
        raise ValueError(f"i4 needs an even segment, got {segment}")
    return segment


def i4_fetch_width(count: int, k: int) -> int:
    """Candidate fetch width for an exact re-rank over i4 storage.

    i4 scoring noise is ~16x i8's, so the i8 default of k + 30 candidates
    loses re-ranked recall. The reference's measured ladder on 384-d
    random unit rows: 64 up to 500k rows, 128 up to 2M, 256 up to 8M, 512
    beyond (dawnsearch_tpu/ops/quant.py:322-343)."""
    if count <= 500_000:
        kf = 64
    elif count <= 2_000_000:
        kf = 128
    elif count <= 8_000_000:
        kf = 256
    else:
        kf = 512
    return max(kf, k)


# ---------------------------------------------------------------------------
# wire codecs (host-side, numpy — network serialization formats)
# ---------------------------------------------------------------------------

I24_MAX = 0x7FFFFF
I8_WIRE_BYTES = EM_LEN + 4  # D codes + f32 scale


def _check_unit(v: np.ndarray) -> None:
    l = float(np.linalg.norm(v.astype(np.float64)))
    if not (1.0 - MAX_VECTOR_DELTA < l < 1.0 + MAX_VECTOR_DELTA):
        raise ValueError("Embedding is not normalized")


def to_i8_wire_bytes(v: np.ndarray) -> bytes:
    """f32[D] unit vector -> D little-endian int8 codes + f32 scale (the
    dawn wire's 1 byte/dim option; symmetric per-vector scale)."""
    v = np.asarray(v, dtype=np.float32)
    scale = float(np.max(np.abs(v)))
    if scale == 0.0:
        scale = 1.0
    q = np.clip(np.rint(v / scale * 127.0), -127, 127).astype(np.int8)
    return q.tobytes() + struct.pack("<f", scale)


def from_i8_wire_bytes(data: bytes, dim: int = EM_LEN,
                       check: bool = True) -> np.ndarray:
    """D+4 bytes -> f32[D]. Validates the scale and (like the i24
    decoder, vector.rs:70) the decoded norm, so a hostile frame cannot
    smuggle an unnormalized query past the distance math."""
    if len(data) != dim + 4:
        raise ValueError(f"expected {dim + 4} bytes, got {len(data)}")
    (scale,) = struct.unpack("<f", data[dim:])
    # unit vectors have max|v| <= 1; the same slack as the norm check
    if not np.isfinite(scale) or not 0.0 < scale <= 1.0 + MAX_VECTOR_DELTA:
        raise ValueError("i8 wire scale out of range")
    q = np.frombuffer(data[:dim], dtype=np.int8).astype(np.float32)
    v = q * np.float32(scale / 127.0)
    if check:
        _check_unit(v)
    return v


def to_i24_bytes(v: np.ndarray) -> bytes:
    """f32[D] in [-1,1] -> 3*D little-endian bytes (vector.rs:74-86)."""
    v = np.asarray(v, dtype=np.float64)
    q = (((v + 1.0) / 2.0) * I24_MAX).astype(np.int64)
    q = np.clip(q, 0, I24_MAX).astype(np.uint32)
    out = np.empty((v.shape[-1], 3), dtype=np.uint8)
    out[:, 0] = q & 0xFF
    out[:, 1] = (q >> 8) & 0xFF
    out[:, 2] = (q >> 16) & 0xFF
    return out.tobytes()


def from_i24_bytes(data: bytes, dim: int = EM_LEN,
                   check: bool = True) -> np.ndarray:
    """3*D bytes -> f32[D] (vector.rs:57-72). Validates normalization
    like the reference's decode (vector.rs:70) unless check=False."""
    if len(data) != dim * 3:
        raise ValueError(f"expected {dim * 3} bytes, got {len(data)}")
    raw = np.frombuffer(data, dtype=np.uint8).reshape(dim, 3).astype(np.uint32)
    q = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
    v = (q.astype(np.float64) / I24_MAX * 2.0 - 1.0).astype(np.float32)
    if check:
        _check_unit(v)
    return v
