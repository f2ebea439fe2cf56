"""FlatIndex: device-resident brute-force top-k over a preallocated buffer.

Port of dawnsearch_tpu/index/flat.py. Same design, the same storage
dtypes and the same snapshot format:

- a preallocated buffer grown in 16,384-row segments (doubling), rows
  beyond `count` masked to +inf distance;
- storage: f32 (the exactness oracle); bf16; i8 with a per-row symmetric
  scale (absmax/127); i4, the capacity tier, row-block nibble packed
  ((capacity/2, D) uint8, ops/quant.py) with a per-row scale (absmax/7).
  Numpy input quantizes on the host (i4 rows that make whole blocks are
  packed there too and land without a read-modify-write), tensor input
  on the device;
- the chunked exact path (`search_kernel`) in plain torch: the f32 oracle
  and every search below `scan_select.MIN_ROWS`;
- the fused score+select (ops/scan_select.py: K2 for i8 and bf16, K3 for
  i4) at and above that count, for capacities that are whole 16,384-row
  tiles (and, for i4, codes packed in blocks of that size);
- an optional f16 shadow buffer and device-side exact re-rank
  (`rerank_kernel`);
- .npz snapshots with the reference's keys, so either package loads the
  other's files.

Distances are 1 - <q, x>, ascending. JAX's buffer donation becomes an
in-place write into the preallocated tensors; all work is enqueued on the
device's current stream, so a search enqueued before an ingest write is
ordered before it.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import torch

from dawnsearch_tpu_torch.ops import scan_select
from dawnsearch_tpu_torch.ops.quant import (i4_block_for, i4_fetch_width,
                                            pack_i4_np, quantize_i4_vals,
                                            quantize_i4_vals_np, unpack_i4,
                                            unpack_i4_np, unpack_i4_vals,
                                            write_rows_i4)
from dawnsearch_tpu_torch.ops.topk import merge_topk, top_k_smallest
from dawnsearch_tpu_torch.ops.vector import EM_LEN

# Segment granularity = the fused selector's row tile, so every grown
# capacity qualifies for the fused path.
DEFAULT_SEGMENT = 16384
DEFAULT_CHUNK = 65536
_TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "i8": torch.int8, "i4": torch.uint8}
# bytes of selector temporaries per query per 128 rows of capacity:
# candidate values + ids and the first fold's halves and mask
_FUSED_BYTES_PER_CANDIDATE = 24


class IndexFull(RuntimeError):
    """Deterministic capacity refusal (the reference's 1M-page cap,
    search_provider.rs:164-166)."""


# The npy dtype string numpy writes for ml_dtypes' bfloat16, which the
# reference's snapshots carry; numpy without ml_dtypes reads it as V2.
_BF16_DESCR = "<V2"


def _atomic_savez(path: str, descr: dict | None = None, **arrays) -> None:
    """np.savez's archive (uncompressed zip of .npy members) + atomic
    rename. `descr` overrides a member's dtype string in its header:
    bf16 codes go out as their 16-bit patterns under _BF16_DESCR, so the
    member's bytes equal the reference's."""
    descr = descr or {}
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asanyarray(val)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if key in descr:
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": descr[key], "fortran_order": False,
                            "shape": val.shape})
                    f.write(np.ascontiguousarray(val).tobytes())
                else:
                    np.lib.format.write_array(f, val, allow_pickle=False)
    os.replace(tmp, path)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def quantize_rows_i8(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, D) -> (i8 codes, f32 scales (n,)): per-row absmax/127, scale
    floored at 1e-12/127, round half to even, clip to ±127."""
    rows = rows.float()
    scales = rows.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
    codes = torch.round(rows / scales[:, None]).clamp(-127, 127)
    return codes.to(torch.int8), scales


def _quantize_rows_i8_np(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    absmax = np.abs(rows).max(axis=1)
    scales = (np.maximum(absmax, 1e-12) / 127.0).astype(np.float32)
    codes = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def _chunk_scores(q: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor | None,
                  i4_block: int | None = None) -> torch.Tensor:
    """(B, D) x (C, D) -> (B, C) distances 1 - dot. f32 storage scores in
    f32 (the exactness oracle); bf16, i8 and i4 storage take bf16-rounded
    queries against the stored values (exact in bf16) with f32
    accumulation, as the reference. i4 chunks arrive packed, (C/2, D)
    covering whole blocks, and unpack to natural row order."""
    if codes.dtype == torch.float32:
        return 1.0 - q @ codes.T
    if codes.dtype == torch.uint8:
        codes = unpack_i4(codes, i4_block)
    dots = q.bfloat16().float() @ codes.float().T
    return 1.0 - (dots if scales is None else dots * scales[None, :])


def search_kernel(codes: torch.Tensor, scales: torch.Tensor | None,
                  queries: torch.Tensor, count: int, k: int, chunk: int,
                  i4_block: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked exact search -> (distances (B, k) ascending, row ids (B, k)).

    Rows >= count score +inf; slots without a row come back (+inf, -1).
    A running top-k merges chunk by chunk, bounding the score matrix to
    (B, chunk). `chunk` and `count` are logical rows; packed i4 codes
    need their packing block, which divides `chunk` (FlatIndex checks)."""
    q = queries.float()
    i4 = codes.dtype == torch.uint8
    if i4 and i4_block is None:
        raise ValueError("i4 codes need the index's packing block")
    cap = codes.shape[0] * (2 if i4 else 1)
    best = None
    for c0 in range(0, cap, chunk):
        c1 = min(cap, c0 + chunk)
        part = codes[c0 // 2:c1 // 2] if i4 else codes[c0:c1]
        s = _chunk_scores(q, part, None if scales is None else scales[c0:c1],
                          i4_block)
        gid = torch.arange(c0, c1, dtype=torch.int32, device=codes.device)
        s = torch.where(gid[None, :] < count, s, torch.inf)
        vals, idx = top_k_smallest(s, min(k, c1 - c0))
        cand = (vals, gid[idx])
        best = cand if best is None else merge_topk(*best, *cand, k)
    d, i = best
    return d, torch.where(torch.isfinite(d), i, -1)


def rerank_kernel(exact: torch.Tensor, q: torch.Tensor, dists: torch.Tensor,
                  ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of scan candidates from the f16 shadow buffer: gather
    the (B, kf) candidate rows, re-score at f32, keep the best k. Invalid
    candidates (id -1 / +inf) stay masked."""
    cand = exact[ids.clamp_min(0).long()].float()              # (B, kf, D)
    exact_d = 1.0 - torch.einsum("bd,bkd->bk", q.float(), cand)
    valid = (ids >= 0) & torch.isfinite(dists)
    d = torch.where(valid, exact_d, torch.inf)
    out_d, sel = top_k_smallest(d, min(k, d.shape[1]))
    out_i = torch.where(torch.isfinite(out_d), torch.gather(ids, 1, sel), -1)
    return out_d, out_i


def _check_unit_queries(queries, count: int, capacity: int, dim: int,
                        dtype: str, min_rows: int) -> None:
    """Raise on non-unit host queries when the fused selector would serve
    them (its packed-key compare is only correct for |dot| < 2). Mirrors
    SearchProvider.search_embeddings' 1% tolerance."""
    if not isinstance(queries, np.ndarray):
        return  # device tensors: avoid a readback; the provider checks
    if not scan_select.eligible(count, capacity, dim, dtype, min_rows):
        return
    q = np.atleast_2d(np.asarray(queries, np.float32))
    if q.shape[0] == 0:
        return
    norms = np.linalg.norm(q, axis=1)
    if not np.all(np.abs(norms - 1.0) <= 0.01):
        bad = float(norms[np.argmax(np.abs(norms - 1.0))])
        raise ValueError(
            f"query embedding not normalized (length {bad:.4f}); the "
            "fused selector requires unit queries — normalize before "
            "searching")


class FlatIndex:
    """Append-only exact index on one device."""

    def __init__(
        self,
        dim: int = EM_LEN,
        dtype: str = "i8",
        capacity: int = DEFAULT_SEGMENT,
        max_capacity: int | None = None,
        segment: int = DEFAULT_SEGMENT,
        chunk: int = DEFAULT_CHUNK,
        exact: str | None = None,
        rerank_extra: int = 30,
        *,
        device,
        _alloc: bool = True,
    ):
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported dtype {dtype}")
        if exact not in (None, "f16"):
            raise ValueError(f"unsupported exact dtype {exact}")
        if exact and dtype == "f32":
            raise ValueError("exact shadow buffer is redundant for f32 storage")
        if dtype == "i4" and dim % 2:
            raise ValueError("i4 nibble packing needs an even dim")
        self.dim = dim
        self.dtype = dtype
        self.exact = exact
        self.rerank_extra = rerank_extra
        self.segment = segment
        self.chunk = chunk
        self.fused_min_rows = scan_select.MIN_ROWS  # see scan_select.eligible
        self.max_capacity = max_capacity
        self.device = torch.device(device)
        self.count = 0
        self.capacity = _round_up(max(capacity, segment), segment)
        self._i4_block = None
        if dtype == "i4":
            # block-aligned growth and whole-block chunks keep the
            # row-block layout position-stable (ops/quant.py)
            self._i4_block = i4_block_for(segment)
            if chunk % self._i4_block:
                raise ValueError(
                    f"i4 chunked scan needs chunk % block == 0, got "
                    f"chunk={chunk} block={self._i4_block}")
        self._codes = self._scales = self._exact = None
        if not _alloc:
            return  # load() binds snapshot buffers
        self._codes = torch.zeros((self._stored_rows(self.capacity), dim),
                                  dtype=_TORCH_DTYPES[dtype], device=self.device)
        if dtype in ("i8", "i4"):
            self._scales = torch.ones((self.capacity,), dtype=torch.float32,
                                      device=self.device)
        if exact:
            self._exact = torch.zeros((self.capacity, dim), dtype=torch.float16,
                                      device=self.device)

    def __len__(self) -> int:
        return self.count

    @property
    def device_rerank(self) -> bool:
        """True when search() already returns exactly re-ranked results
        (callers can skip their own host-side f32 re-rank)."""
        return self._exact is not None

    def device_fetch_width(self, k: int) -> int:
        """Candidate width for the on-device f16 re-rank: k + rerank_extra,
        widened by the count-keyed ladder for i4 codes (as the provider's
        host re-rank, SearchProvider.fetch_width)."""
        kf = k + self.rerank_extra
        if self.dtype == "i4":
            kf = max(kf, i4_fetch_width(self.count, k))
        return min(kf, self.capacity)

    def _stored_rows(self, logical: int) -> int:
        """Rows of the codes buffer holding `logical` rows (i4 packs 2)."""
        return logical // 2 if self.dtype == "i4" else logical

    def fused_eligible(self) -> bool:
        """Whether a search now takes the fused selector (scan_select's
        gate, and for i4 codes packed in blocks of one selector tile)."""
        return (scan_select.eligible(self.count, self.capacity, self.dim,
                                     self.dtype, self.fused_min_rows)
                and (self.dtype != "i4"
                     or self._i4_block == scan_select.DEFAULT_TN))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self._codes, self._scales, self._exact)
                   if t is not None)

    def _grow_to(self, needed: int) -> None:
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        if self.max_capacity is not None:
            new_cap = min(_round_up(self.max_capacity, self.segment), new_cap)
        if new_cap <= self.capacity:
            raise IndexFull(
                f"index full: capacity {self.capacity}, need {needed}")
        pad = new_cap - self.capacity

        def grown(t: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
            tail = torch.full((rows, *t.shape[1:]), fill, dtype=t.dtype,
                              device=t.device)
            return torch.cat([t, tail])

        self._codes = grown(self._codes, self._stored_rows(pad), 0)
        if self._scales is not None:
            self._scales = grown(self._scales, pad, 1.0)
        if self._exact is not None:
            self._exact = grown(self._exact, pad, 0)
        self.capacity = new_cap

    def _prepare(self, vectors):
        """Quantize rows for add(): numpy on the host (only the codes
        cross to the device), tensors on their device.
        -> (n, codes, scales | None, f16 | None, packed). i4 codes are
        biased nibble values, or, with `packed`, host-packed whole
        blocks (the reference's _PackedI4: half the bytes cross, and a
        block-aligned add writes them straight in)."""
        if len(vectors) == 0:
            return 0, None, None, None, False
        packed = False
        if isinstance(vectors, np.ndarray):
            rows = np.atleast_2d(np.asarray(vectors, np.float32))
            scales = None
            if self.dtype == "i8":
                codes, scales = _quantize_rows_i8_np(rows)
            elif self.dtype == "i4":
                codes, scales = quantize_i4_vals_np(rows)
                if codes.shape[0] % self._i4_block == 0:
                    codes, packed = pack_i4_np(codes, self._i4_block), True
            else:
                codes = rows
            f16 = rows.astype(np.float16) if self._exact is not None else None
            codes, scales, f16 = (None if a is None else torch.from_numpy(a)
                                  for a in (codes, scales, f16))
            if self.dtype == "bf16":
                codes = codes.bfloat16()  # round half to even, as ml_dtypes
        else:
            rows = torch.atleast_2d(vectors).float()
            scales = None
            if self.dtype == "i8":
                codes, scales = quantize_rows_i8(rows)
            elif self.dtype == "i4":
                codes, scales = quantize_i4_vals(rows)
            else:
                codes = rows.to(_TORCH_DTYPES[self.dtype])
            f16 = rows.half() if self._exact is not None else None
        return rows.shape[0], codes, scales, f16, packed

    def add(self, vectors) -> np.ndarray:
        """Append rows (numpy or tensor); returns their row ids."""
        return self._commit(self._prepare(vectors))

    def _commit(self, prepared) -> np.ndarray:
        """Write one _prepare() result at `count` (growing first when it
        does not fit) -> the rows' ids."""
        n, codes, scales, f16, packed = prepared
        if n == 0:
            return np.empty((0,), np.int64)
        if self.count + n > self.capacity:
            self._grow_to(self.count + n)
        s, e = self.count, self.count + n
        codes = codes.to(self.device)
        if packed and s % self._i4_block == 0:
            # block b of the new rows IS packed rows [s/2 + b*block/2, ...)
            self._codes[s // 2:e // 2] = codes
        elif self.dtype == "i4":
            if packed:  # a misaligned start: back to values, then merge
                codes = unpack_i4_vals(codes, self._i4_block)
            write_rows_i4(self._codes, codes, s, self._i4_block)
        else:
            self._codes[s:e] = codes
        if scales is not None:
            self._scales[s:e] = scales.to(self.device)
        if f16 is not None:
            self._exact[s:e] = f16.to(self.device)
        self.count = e
        return np.arange(s, e, dtype=np.int64)

    def add_stream(self, blocks, prefetch: int = 2) -> np.ndarray:
        """Pipelined bulk append (reference FlatIndex.add_stream): a
        prefetch thread consumes `blocks` (an iterable of (n, dim) arrays)
        and quantizes block k+1 while this thread writes block k. Returns
        the concatenated row ids, identical to sequential add() calls. An
        error of the iterable or of a write surfaces here; the rows
        written before it stay."""
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        end = object()
        stop = threading.Event()  # the consumer died: release the producer

        def put(item) -> bool:
            # a plain put would block forever on a full queue once the
            # consumer has raised (IndexFull mid-stream)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for v in blocks:
                    if not put(self._prepare(v)):
                        return
            except BaseException as e:  # surface on the consumer side
                put(e)
                return
            put(end)

        t = threading.Thread(target=produce, daemon=True,
                             name="flatindex-add-prefetch")
        t.start()
        out = []
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                out.append(self._commit(item))
        finally:
            stop.set()
            t.join(timeout=60)
        return np.concatenate(out) if out else np.empty((0,), np.int64)

    def reconstruct(self, row_id: int) -> np.ndarray:
        """The stored vector of a row, approximately: the f16 shadow when
        kept, else the dequantized codes (f32)."""
        if self._exact is not None:
            return self._exact[row_id].float().cpu().numpy()
        if self.dtype == "i4":
            # row-block layout: logical row r is packed row
            # (r // T)·T/2 + r % (T/2), low nibble in a block's first
            # half, high nibble in its second (ops/quant.py)
            t = self._i4_block
            b, off = divmod(row_id, t)
            packed = self._codes[b * (t // 2) + off % (t // 2)].cpu().numpy()
            nib = packed >> 4 if off >= t // 2 else packed & 0xF
            row = nib.astype(np.float32) - 8.0
        else:
            row = self._codes[row_id].float().cpu().numpy()
        if self._scales is not None:
            row *= float(self._scales[row_id])
        return row

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k -> (distances (B, k) ascending, ids (B, k); -1 = empty).
        Queries must be unit vectors once the fused selector serves
        (count >= fused_min_rows); numpy queries are checked here."""
        d, i, k_eff, single = self.search_dispatch(queries, k)
        return self.search_finalize(d, i, k, k_eff, single)

    def search_dispatch(self, queries, k: int):
        """Enqueue the search without waiting for it -> opaque state for
        search_finalize (the provider holds its device lock only here)."""
        _check_unit_queries(queries, self.count, self.capacity, self.dim,
                            self.dtype, self.fused_min_rows)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        k_eff = min(k, self.capacity)
        if self.fused_eligible():
            bm = self._max_fused_batch()
            parts = [self._search_fused(q[s:s + bm], k_eff)
                     for s in range(0, q.shape[0], bm)]
            d = torch.cat([p[0] for p in parts])
            i = torch.cat([p[1] for p in parts])
        elif self._exact is not None:
            d, i = search_kernel(self._codes, self._scales, q, self.count,
                                 self.device_fetch_width(k_eff), self.chunk,
                                 self._i4_block)
            d, i = rerank_kernel(self._exact, q, d, i, k_eff)
        else:
            d, i = search_kernel(self._codes, self._scales, q, self.count,
                                 k_eff, self.chunk, self._i4_block)
        return d, i, k_eff, single

    def _max_fused_batch(self) -> int:
        """Largest query batch one fused search serves before its
        candidate temporaries would outgrow free device memory (0.75 GiB
        kept back); a larger batch runs in power-of-two slices. The CPU
        has no such envelope."""
        if self.device.type != "cuda":
            return 1 << 30
        free, _ = torch.cuda.mem_get_info(self.device)
        per_query = _FUSED_BYTES_PER_CANDIDATE * (self.capacity // 128)
        b = min(1 << 30, max(8, (free - (3 << 30) // 4) // per_query))
        return 1 << (int(b).bit_length() - 1)

    def _search_fused(self, q: torch.Tensor, k: int):
        """K2 / K3 score+select; composes with the f16 device re-rank."""
        if self._exact is not None:
            d, i = scan_select.search_select(self._codes, self._scales, q,
                                             self.count,
                                             self.device_fetch_width(k))
            return rerank_kernel(self._exact, q, d, i, k)
        return scan_select.search_select(self._codes, self._scales, q,
                                         self.count, k)

    @staticmethod
    def search_finalize(d, i, k: int, k_eff: int, single: bool
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Wait for the dispatched search and shape the host results."""
        d, i = d.cpu().numpy(), i.cpu().numpy()
        if k_eff < k:  # pad to requested k
            d = np.pad(d, ((0, 0), (0, k - k_eff)), constant_values=np.inf)
            i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
        if single:
            return d[0], i[0]
        return d, i

    # -- persistence (reference: index.usearch save/load,
    #    search_provider.rs:111-125,173-181) --

    def save(self, path: str) -> None:
        self.deferred_save()(path)

    def deferred_save(self):
        """Capture the buffers now and return a closure that reads them
        back and writes the .npz. Writes land in place, so the closure
        must run while no add or ingest can write (SearchProvider.save
        holds its ingest_gate across it); searches may keep running."""
        codes, scales, exact = self._codes, self._scales, self._exact
        count, dtype, dim = self.count, self.dtype, self.dim
        i4_block = self._i4_block or 0
        bf16 = codes.dtype == torch.bfloat16

        def write(path: str) -> None:
            _atomic_savez(
                path,
                descr={"codes": _BF16_DESCR} if bf16 else None,
                codes=(codes.view(torch.int16) if bf16 else codes).cpu().numpy(),
                scales=(scales.cpu().numpy() if scales is not None
                        else np.empty(0)),
                exact=(exact.cpu().numpy() if exact is not None
                       else np.empty(0)),
                count=count,
                dtype=dtype,
                dim=dim,
                # i4 codes are position-dependent (row-block packing)
                i4_block=i4_block,
            )
        return write

    @classmethod
    def load(cls, path: str, **kwargs) -> "FlatIndex":
        with np.load(path, allow_pickle=False) as z:
            dtype = str(z["dtype"])
            dim = int(z["dim"])
            count = int(z["count"])
            codes = z["codes"]
            scales = z["scales"]
            exact = z["exact"] if "exact" in z.files else np.empty(0)
            snap_block = int(z["i4_block"]) if "i4_block" in z.files else 0
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"snapshot dtype {dtype} is not served; the "
                             "provider rebuilds from the page store")
        has_exact = exact.size > 0
        kwargs.setdefault("exact", "f16" if has_exact else None)
        if dtype == "i4":
            if snap_block == 0:
                raise ValueError(
                    "i4 snapshot in the legacy per-row dim-plane layout "
                    "(i4_block 0) is not migrated; the provider rebuilds "
                    "from the page store")
            idx = cls(dim=dim, dtype=dtype, capacity=codes.shape[0] * 2,
                      _alloc=False, **kwargs)
            if snap_block != idx._i4_block:
                # saved under another segment policy: repack into this
                # index's blocks; the padded tail is masked by count
                vals = (unpack_i4_np(codes, snap_block).astype(np.int16)
                        + 8).astype(np.uint8)
                vals = np.pad(vals, ((0, idx.capacity - vals.shape[0]),
                                     (0, 0)))
                codes = pack_i4_np(vals, idx._i4_block)
            scales = np.pad(scales, (0, codes.shape[0] * 2 - scales.shape[0]),
                            constant_values=1.0)
        else:
            idx = cls(dim=dim, dtype=dtype, capacity=codes.shape[0],
                      _alloc=False, **kwargs)
        dev = idx.device
        if dtype == "bf16":
            # the reference writes bf16 as 16-bit patterns (numpy V2); the
            # card's machine has no ml_dtypes, so read them as int16
            idx._codes = torch.from_numpy(
                np.ascontiguousarray(codes).view(np.int16)).to(dev).view(
                    torch.bfloat16)
        else:
            idx._codes = torch.from_numpy(codes).to(dev, _TORCH_DTYPES[dtype])
        if dtype in ("i8", "i4"):
            idx._scales = torch.from_numpy(scales).to(dev, torch.float32)
        # config is policy: an explicit exact=None drops a snapshot's
        # shadow; a requested shadow the snapshot lacks is backfilled from
        # the dequantized codes (an all-zero shadow would score every
        # candidate at distance 1)
        if has_exact and idx.exact == "f16":
            idx._exact = torch.from_numpy(exact).to(dev, torch.float16)
        elif idx.exact == "f16":
            deq = (unpack_i4(idx._codes, idx._i4_block) if dtype == "i4"
                   else idx._codes).float()
            if idx._scales is not None:
                deq = deq * idx._scales[:, None]
            idx._exact = deq.half()
        idx.count = count
        idx.capacity = codes.shape[0] * (2 if dtype == "i4" else 1)
        return idx
