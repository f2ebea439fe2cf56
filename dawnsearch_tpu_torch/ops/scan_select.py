"""Fused score + window select: the K2 and K3 CUDA kernels and their plain twins.

Counterpart of dawnsearch_tpu/ops/scan_select.py (the TPU kernels
`_candidates` / `_select_kernel` (K2) and `_candidates_i4` /
`_select_kernel_i4` (K3), which share the tail `_mask_select_store`).
Every variant scores a query batch against the index codes and reduces
every strided window of W = 128 rows of a 16384-row tile to one
packed-key minimum: column t·128 + r of the output is the minimum over
rows t·16384 + w·128 + r, w < 128. Outside the kernel the candidate
columns fold by halves and an exact top-k finishes (search_select).

The variants, by code format and query type (`qi8`):

| codes | qi8 | scoring | METRICS / `launches` key |
|---|---|---|---|
| i8 (N, D) + scales | True | s8·s8 -> s32, db = 2 - (dot·qs)·scale | kernel_select |
| i8 (N, D) + scales | False | bf16 q · i8 codes, f32, db = 2 - dot·scale | kernel_select_i8_qbf16 |
| bf16 (N, D) | False | bf16 q · bf16 codes, f32, db = 2 - dot | kernel_select_bf16 |
| i4 (N/2, D) uint8 + scales | True | as i8 qi8, codes unpacked | kernel_select_i4 |
| i4 (N/2, D) uint8 + scales | False | as i8 qi8=False, codes unpacked | kernel_select_i4_qbf16 |

i4 codes are row-block packed with block 16384 (ops/quant.py), so a tile
is one block and the window semantics are the i8 ones. With qi8 the
queries are quantized per row to i8 outside the kernel
(`quantize_queries`); without it they go in as f32 rounded to bf16 (round
half to even), and, as in the reference, no query scale enters.

`select_candidates` launches csrc/scan_select.cu for CUDA tensors and
runs `select_candidates_plain` for CPU tensors; there is no fallback.
`plan_select` sizes the launch: queries a CTA and how many CTAs share a
row tile's window blocks (`split_blocks`), so a small batch still spreads
over the card; tiles wholly past `count` read no codes. The
qi8 variants are bit-equal to their plain twin (exact integer dots, the
epilogue's three separately rounded f32 ops). The bf16 variants sum f32
products of bf16 operands in another order than the plain twin's matmul,
so they agree within a stated tolerance (tests, chip_smoke.py).

Accuracy and the unit-query precondition are the reference's: see its
module docstring.
"""

from __future__ import annotations

import torch

from dawnsearch_tpu_torch.ops import _cuda
from dawnsearch_tpu_torch.ops.quant import I4_BLOCK, unpack_i4
from dawnsearch_tpu_torch.ops.topk import top_k_smallest

W = 128             # rows per candidate window
DEFAULT_TN = 16384  # rows per tile (W * W)

# The windowed-candidate approximation needs count >> k*W (shadowing
# odds ~k^2*W/2N); below this the chunked exact path serves.
MIN_ROWS = 262_144

# Code format ids of the C entry point (csrc/scan_select.cu).
_FMT = {torch.int8: 0, torch.uint8: 1, torch.bfloat16: 2}
# (codes dtype, qi8) -> the variant's launch-counter / METRICS name
VARIANTS = {(torch.int8, True): "kernel_select",
            (torch.int8, False): "kernel_select_i8_qbf16",
            (torch.bfloat16, False): "kernel_select_bf16",
            (torch.uint8, True): "kernel_select_i4",
            (torch.uint8, False): "kernel_select_i4_qbf16"}

# Launches of each CUDA variant in this process; tests and chip_smoke.py
# read and reset them.
launches = dict.fromkeys(VARIANTS.values(), 0)

QUERY_TILES = (8, 64)  # queries a CTA of the CUDA kernel holds
MAX_SPLIT = 16        # CTAs a row tile's window blocks split over
MAX_GRID_Y = 65535    # the launch's row-tile x split grid dimension


def plan_select(B: int, N: int, count: int, sms: int
                ) -> tuple[int, int]:
    """The CUDA kernel's launch shape for B queries over N logical rows of
    which `count` are live, on a card of `sms` SMs -> (qb, s): qb queries a
    CTA (8 for a searcher's small batch, else 64) and s CTAs a 16384-row
    tile, the smallest power of two up to MAX_SPLIT that puts two CTAs on
    every SM over the tiles holding live rows (the others read nothing),
    and no larger than the grid takes (N / 16384 · s <= MAX_GRID_Y). CTA q
    of a tile's s walks the window blocks split_blocks(s, q) of the tile's
    128 (i4: its 64 packed blocks)."""
    qb = next((t for t in QUERY_TILES if B <= t), QUERY_TILES[-1])
    tiles = N // DEFAULT_TN
    live = min(tiles, max(0, -(-count // DEFAULT_TN)))
    qtiles = -(-B // qb)
    s = 1
    while (s < MAX_SPLIT and tiles * s * 2 <= MAX_GRID_Y
           and qtiles * live * s < 2 * sms):
        s *= 2
    return qb, s


def split_blocks(s: int, q: int, blocks: int = W) -> range:
    """The blocks of a tile that CTA q of its s walks (csrc/scan_select.cu
    select_kernel's blk0 .. blk1): an equal, contiguous share."""
    per = blocks // s
    return range(q * per, (q + 1) * per)


def supports(capacity: int, dim: int, dtype: str,
             tn: int = DEFAULT_TN) -> bool:
    """Shapes the fused selector serves: i8, bf16 or i4 codes in whole
    16384-row tiles (the reference's gate, kept so both packages choose
    the same path). i4 codes are packed in blocks of I4_BLOCK, one per
    tile, so i4 pins tn to it; the caller guarantees its codes were
    packed with that block (FlatIndex.fused_eligible)."""
    if dtype == "i4" and tn != I4_BLOCK:
        return False
    return (dtype in ("i8", "bf16", "i4") and tn == DEFAULT_TN
            and capacity % tn == 0 and capacity >= tn and dim % 128 == 0)


def eligible(count: int, capacity: int, dim: int, dtype: str,
             min_rows: int = MIN_ROWS) -> bool:
    """The serving-default gate shared by FlatIndex and the fused query
    path (reference scan_select.eligible)."""
    return count >= min_rows and supports(capacity, dim, dtype)


def quantize_queries(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D) f32 -> (i8 codes (B, D), f32 scales (B,)). Per-row absmax/127
    with the max floored at 1e-30, divide then round half to even, as the
    reference (ops/scan_select.py:274-277); zero rows give zero codes."""
    q = q.float()
    qs = q.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 127.0
    return torch.round(q / qs).to(torch.int8), qs.reshape(-1)


def _logical_rows(codes: torch.Tensor) -> int:
    return codes.shape[0] * (2 if codes.dtype == torch.uint8 else 1)


def select_candidates_plain(q: torch.Tensor, qs: torch.Tensor | None,
                            codes: torch.Tensor, scales: torch.Tensor | None,
                            count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference semantics of every variant -> (vals, ids), (B, N/128).

    `q` is i8 with its scales `qs` (qi8) or bf16 with `qs` None. With i8
    queries the dot runs as an f32 product of integers: every partial sum
    is below 127·127·D < 2^24 at D <= 1024, so f32 holds it exactly in
    any order (an int32 matmul has no CUDA implementation in torch). With
    bf16 queries it is an f32 product of bf16-rounded operands (i8 and i4
    codes widen to bf16 exactly). The epilogue is separately rounded f32
    ops, the kernel's order."""
    B = q.shape[0]
    N = _logical_rows(codes)
    T = N // DEFAULT_TN
    x = unpack_i4(codes, I4_BLOCK) if codes.dtype == torch.uint8 else codes
    dots = q.float() @ x.float().T
    if qs is not None:
        dots = dots * qs.reshape(B, 1)
    db = 2.0 - (dots if scales is None else dots * scales.reshape(1, N))
    rows = torch.arange(N, device=codes.device)
    db = torch.where(rows < count, db, torch.inf)
    keys = (db.view(torch.int32) & ~0x7F).reshape(B, T, W, W)
    keys = keys | torch.arange(W, dtype=torch.int32,
                               device=codes.device).reshape(1, 1, W, 1)
    best = keys.amin(dim=2)                                   # (B, T, R)
    vals = (best & ~0x7F).view(torch.float32) - 1.0
    r = torch.arange(W, dtype=torch.int32, device=codes.device)
    t = torch.arange(T, dtype=torch.int32, device=codes.device)
    ids = (t.reshape(1, T, 1) * DEFAULT_TN + (best & 0x7F) * W
           + r.reshape(1, 1, W))
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals.reshape(B, T * W), ids.reshape(B, T * W)


def select_candidates(q: torch.Tensor, qs: torch.Tensor | None,
                      codes: torch.Tensor, scales: torch.Tensor | None,
                      count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 / K3: the CUDA kernel for CUDA tensors, the plain version on CPU.
    The code format comes from codes.dtype (int8 i8, uint8 packed i4,
    bfloat16 bf16) and qi8 from q.dtype (int8 with scales `qs`, or
    bfloat16 with `qs` None)."""
    if not codes.is_cuda:
        return select_candidates_plain(q, qs, codes, scales, count)
    B, D = q.shape
    N = _logical_rows(codes)
    qi8 = q.dtype == torch.int8
    name = VARIANTS.get((codes.dtype, qi8))
    if name is None:
        raise ValueError(f"no select kernel for {codes.dtype} codes with "
                         f"{q.dtype} queries")
    dev = codes.device
    want = [("q", q, q.dtype, (B, D)),
            ("codes", codes, codes.dtype, (codes.shape[0], D))]
    if qi8:
        want.append(("qs", qs, torch.float32, (B,)))
    if codes.dtype != torch.bfloat16:
        want.append(("scales", scales, torch.float32, (N,)))
    for what, t, dt, shape in want:
        if t is None or t.dtype != dt or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} {what}: want contiguous 16-byte aligned "
                             f"{dt} {shape} on {dev}, got " + (
                                 "None" if t is None else
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}"))
    if N % DEFAULT_TN or D % 128:
        raise ValueError(f"{name} needs {DEFAULT_TN}-row tiles and "
                         f"D % 128 == 0, got codes {tuple(codes.shape)}")
    vals = torch.empty((B, N // W), dtype=torch.float32, device=dev)
    ids = torch.empty((B, N // W), dtype=torch.int32, device=dev)
    qb, s = plan_select(B, N, int(count),
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    _cuda.check(_cuda.lib().dawn_select(
        _FMT[codes.dtype], int(qi8), q.data_ptr(),
        qs.data_ptr() if qi8 else None, codes.data_ptr(),
        None if scales is None else scales.data_ptr(), int(count),
        vals.data_ptr(), ids.data_ptr(), B, N, D, qb, s,
        _cuda.stream_handle(codes)), name)
    _cuda.count(launches, name)
    return vals, ids


def search_select(codes: torch.Tensor, scales: torch.Tensor | None,
                  queries: torch.Tensor, count: int, k: int,
                  tn: int = DEFAULT_TN, qi8: bool | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D) queries vs i8 (N, D), bf16 (N, D) or packed i4 (N/2, D)
    codes -> (B, k) distances ascending and global row ids; empty slots
    are (+inf, -1). qi8 defaults to True for i8 and i4 codes and to False
    for bf16 codes (the reference's QI8_DEFAULT)."""
    N, D = _logical_rows(codes), codes.shape[1]
    if codes.dtype not in _FMT:
        raise NotImplementedError(
            f"the fused selector scores i8, bf16 and i4 codes, not "
            f"{codes.dtype} (f32 stays on the chunked exact path)")
    if tn != DEFAULT_TN or N % tn != 0 or D % 128 != 0:
        # a non-multiple capacity would leave candidate columns unwritten
        # (the reference saw recall fall to 0.77 from exactly that); the
        # one tile size is also i4's packing block (I4_BLOCK), so i4 rows
        # cannot be permuted by another tn
        raise ValueError(
            f"search_select needs capacity % {DEFAULT_TN} == 0 and "
            f"dim % 128 == 0, got codes {tuple(codes.shape)}; pad the buffer "
            "(see supports())")
    if qi8 is None:
        qi8 = codes.dtype != torch.bfloat16
    if qi8 and codes.dtype == torch.bfloat16:
        raise ValueError("bf16 codes score bf16 queries (qi8=False)")
    if qi8:
        q, qs = quantize_queries(queries)
    else:
        q, qs = queries.float().bfloat16(), None
    vals, ids = select_candidates(q, qs, codes, scales, count)
    return fold_topk(vals, ids, k)


def fold_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate columns -> exact top-k. Contiguous halves fold pairwise
    (column j against j + C/2; ties keep the left half) down to <= 4096
    columns, at most 1024 effective rows per candidate (reference
    scan_select.py:408-414); then a stable smallest-k."""
    eff_w = W
    while vals.shape[1] > 4096 and eff_w < 1024:
        eff_w *= 2
        half = vals.shape[1] // 2
        left = vals[:, :half] <= vals[:, half:]
        vals = torch.where(left, vals[:, :half], vals[:, half:])
        ids = torch.where(left, ids[:, :half], ids[:, half:])
    k_eff = min(k, vals.shape[1])
    d, sel = top_k_smallest(vals, k_eff)
    i = torch.gather(ids, 1, sel)
    i = torch.where(torch.isfinite(d), i, -1)
    if k_eff < k:
        d = torch.nn.functional.pad(d, (0, k - k_eff), value=torch.inf)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=-1)
    return d, i
