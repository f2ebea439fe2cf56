"""ShardedFlatIndex: exact search over row shards on the devices of a Mesh.

Port of dawnsearch_tpu/parallel/sharded_index.py. The reference scores
every shard under `shard_map` and merges with `lax.top_k` over an
`all_gather`; here each shard is a set of tensors on its own device, the
host launches every shard's search before it waits on any of them, and
the merge runs on the mesh's first device:

- codes  per shard (cap, D) (i4: (cap/2, D) row-block packed), the vector
  data in f32, bf16, i8 or i4;
- scales per shard (cap,) f32, the i8 / i4 per-row scales;
- exact  per shard (cap, D) f16, the optional shadow for the re-rank;
- ids    per shard (cap,) int32, user ids (default: insertion order);
- counts (S,) int64 on the host, every shard's fill.

A shard's search is the port's K2 (i8, bf16) or K3 (i4) select
(ops/scan_select.search_select) once the least-filled shard passes the
fused gate, else the chunked exact search (index/flat.search_kernel);
with exact="f16" each shard re-ranks its own candidates before the merge.
The merge lays the (S, B, k) distances and ids out shard-major, as the
reference's all_gather + transpose does, and takes a stable top-k, so
equal distances resolve to the lowest position first, as lax.top_k does.

Inserts are planned on the host (balance-striped onto the least-full
shards) and each shard writes its rows in place at its own offset; a
shard that receives no rows is not written. With a query axis (`dp_axis`)
each query group holds a replica of the row shards and serves its slice
of the batch. When the shards span processes (`mesh.process_count` > 1,
parallel/multihost.py), each process holds only its own shards, the host
state (counts, ids, plans) is the same on all of them, and the search's
per-shard results meet in an all_gather over torch.distributed.

Snapshots are the reference's "sharded" .npz, byte for byte: either
package loads the other's, also onto another shard count (re-striped).
"""

from __future__ import annotations

import numpy as np
import torch

from dawnsearch_tpu_torch.index.flat import (_BF16_DESCR, _TORCH_DTYPES,
                                             DEFAULT_CHUNK, DEFAULT_SEGMENT,
                                             IndexFull, _atomic_savez,
                                             _check_unit_queries,
                                             rerank_kernel, search_kernel)
from dawnsearch_tpu_torch.ops import scan_select
from dawnsearch_tpu_torch.ops.quant import (i4_block_for, i4_fetch_width,
                                            pack_i4_np, quantize_i4_vals_np,
                                            unpack_i4_np, write_rows_i4)
from dawnsearch_tpu_torch.ops.topk import top_k_smallest
from dawnsearch_tpu_torch.ops.vector import EM_LEN
from dawnsearch_tpu_torch.parallel.mesh import AXIS, Mesh, make_mesh


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= n (>= lo): the plan's block height, so a
    crew's coalesced flushes take few distinct wire shapes."""
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def _host(a: np.ndarray, dtype=None) -> torch.Tensor:
    """A CPU tensor over `a` (copied when it is read-only or strided)."""
    a = np.require(a, dtype=dtype, requirements=["C", "W"])
    return torch.from_numpy(a)


def merge_shards(all_d: torch.Tensor, all_u: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, B, k) per-shard distances and user ids -> the global top k,
    (B, k): shard-major columns, a stable smallest-k (ties keep the
    lowest column, as the reference's lax.top_k over its all_gather)."""
    S, B, kk = all_d.shape
    d = all_d.permute(1, 0, 2).reshape(B, S * kk)
    u = all_u.permute(1, 0, 2).reshape(B, S * kk)
    vals, sel = top_k_smallest(d, k)
    return vals, torch.gather(u, 1, sel)


def _all_gather(t: torch.Tensor, world: int) -> torch.Tensor:
    """Concatenate every process's `t` along dim 0, rank order (gloo, on
    host copies)."""
    src = t.cpu().contiguous()
    out = [torch.empty_like(src) for _ in range(world)]
    torch.distributed.all_gather(out, src)
    return torch.cat(out)


class ShardedFlatIndex:
    """Exact index sharded over a mesh axis "shard". API mirrors FlatIndex
    but ids are user-assigned (default: global insertion order)."""

    def __init__(
        self,
        mesh: Mesh | None = None,
        dim: int = EM_LEN,
        dtype: str = "i8",
        capacity_per_shard: int = DEFAULT_SEGMENT,
        segment: int = DEFAULT_SEGMENT,
        chunk: int = DEFAULT_CHUNK,
        max_capacity: int | None = None,
        dp_axis: str | None = None,
        exact: str | None = None,
        rerank_extra: int = 30,
    ):
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported dtype {dtype}")
        if dtype == "i4" and dim % 2:
            raise ValueError("i4 nibble packing needs an even dim")
        if exact not in (None, "f16"):
            raise ValueError(f"unsupported exact dtype {exact}")
        if exact and dtype == "f32":
            raise ValueError("exact shadow buffer is redundant for f32 storage")
        self.mesh = mesh if mesh is not None else make_mesh()
        if AXIS not in self.mesh.axis_names:
            raise ValueError(f'mesh must have a "{AXIS}" axis')
        if dp_axis is not None and dp_axis not in self.mesh.axis_names:
            raise ValueError(f'mesh has no "{dp_axis}" axis')
        if dp_axis is not None and self.mesh.process_count > 1:
            raise ValueError("a query axis (dp_axis) needs the whole mesh "
                             "in one process")
        # Optional query-data-parallel axis: query batches split over it
        # while each group holds a replica of the row shards (memory x
        # the group count), the reference's serving trade.
        self.dp_axis = dp_axis
        self.n_shards = self.mesh.shape[AXIS]
        self._groups = self._device_groups()
        self._world = self.mesh.process_count
        self._first = self.mesh.process_index * self.mesh.local_shards
        self.dim = dim
        self.dtype = dtype
        self.segment = segment
        self.chunk = chunk
        self.fused_min_rows = scan_select.MIN_ROWS  # per-shard select gate
        self.max_capacity = max_capacity
        self.cap_per_shard = _round_up(max(capacity_per_shard, segment),
                                       segment)
        self._counts = np.zeros(self.n_shards, dtype=np.int64)
        self._next_id = 0
        self._i4_block = None
        if dtype == "i4":
            # row-block nibble packing per shard (ops/quant.py)
            self._i4_block = i4_block_for(segment)
            if chunk % self._i4_block != 0:
                raise ValueError(
                    f"i4 chunked scan needs chunk % block == 0, got "
                    f"chunk={chunk} block={self._i4_block}")
        self.exact = exact
        self.rerank_extra = rerank_extra
        cap = self.cap_per_shard
        self._codes = self._alloc(lambda d: torch.zeros(
            (self._stored_rows(cap), dim), dtype=_TORCH_DTYPES[dtype],
            device=d))
        self._scales = (self._alloc(lambda d: torch.ones(
            (cap,), dtype=torch.float32, device=d))
            if self._has_scales else None)
        self._exact = (self._alloc(lambda d: torch.zeros(
            (cap, dim), dtype=torch.float16, device=d)) if exact else None)
        self._ids = self._alloc(lambda d: torch.full(
            (cap,), -1, dtype=torch.int32, device=d))

    def _device_groups(self) -> list[list[torch.device]]:
        """The devices of each query group's row shards: [group][shard]
        (one group without a dp_axis; other axes take their first
        device)."""
        names = self.mesh.axis_names
        take = tuple(slice(None) if n in (AXIS, self.dp_axis) else 0
                     for n in names)
        grid = self.mesh.devices[take]
        kept = [n for n in names if n in (AXIS, self.dp_axis)]
        if self.dp_axis is None:
            grid = grid[None]
        else:
            grid = np.moveaxis(grid, kept.index(self.dp_axis), 0)
        return [list(row) for row in grid]

    def _alloc(self, make) -> list[list[torch.Tensor]]:
        return [[make(d) for d in group] for group in self._groups]

    @property
    def _has_scales(self) -> bool:
        return self.dtype in ("i8", "i4")

    def _stored_rows(self, logical: int) -> int:
        return logical // 2 if self.dtype == "i4" else logical

    @property
    def device_rerank(self) -> bool:
        return self.exact is not None

    def device_fetch_width(self, k: int) -> int:
        """Per-shard candidate width for the on-device f16 re-rank —
        k+rerank_extra widened by the i4 ladder on the TOTAL row count
        (conservative: each shard holds 1/S of the rows, so the global
        width per shard over-fetches; FlatIndex.device_fetch_width is
        the single-shard twin)."""
        kf = k + self.rerank_extra
        if self.dtype == "i4":
            kf = max(kf, i4_fetch_width(len(self), k))
        return min(kf, self.cap_per_shard)

    def __len__(self) -> int:
        return int(self._counts.sum())

    @property
    def capacity(self) -> int:
        return self.n_shards * self.cap_per_shard

    @property
    def nbytes(self) -> int:
        """Bytes of the index's buffers across every shard (one replica)."""
        S, cap, D = self.n_shards, self.cap_per_shard, self.dim
        item = torch.empty((), dtype=_TORCH_DTYPES[self.dtype]).element_size()
        n = S * self._stored_rows(cap) * D * item + S * cap * 4
        if self._has_scales:
            n += S * cap * 4
        if self.exact:
            n += S * cap * D * 2
        return n

    def _grow(self, needed_per_shard: int) -> None:
        new_cap = self.cap_per_shard
        while new_cap < needed_per_shard:
            new_cap *= 2
        if self.max_capacity is not None:
            limit = _round_up(
                -(-self.max_capacity // self.n_shards), self.segment)
            new_cap = min(new_cap, max(limit, self.cap_per_shard))
        if new_cap <= self.cap_per_shard:
            raise IndexFull("sharded index full")
        pad = new_cap - self.cap_per_shard

        def grown(bufs, rows: int, fill) -> list:
            return [[torch.cat([t, torch.full((rows, *t.shape[1:]), fill,
                                              dtype=t.dtype,
                                              device=t.device)])
                     for t in group] for group in bufs]

        self._codes = grown(self._codes, self._stored_rows(pad), 0)
        if self._scales is not None:
            self._scales = grown(self._scales, pad, 1.0)
        if self._exact is not None:
            self._exact = grown(self._exact, pad, 0)
        self._ids = grown(self._ids, pad, -1)
        self.cap_per_shard = new_cap

    def free_slots(self) -> int | None:
        """Total rows still insertable after all permitted growth, or
        None when growth is unbounded (max_capacity=None). Mirrors
        _plan_insert's refusal condition, so a caller that pre-checks
        occupancy against this (the multihost ADD coalescer) refuses
        exactly when a direct add() would."""
        if self.max_capacity is None:
            return None
        limit = max(_round_up(-(-self.max_capacity // self.n_shards),
                              self.segment), self.cap_per_shard)
        return int((limit - self._counts).sum())

    def _stripe_plan(self, n: int, room: np.ndarray | None = None
                     ) -> tuple[list[np.ndarray], int]:
        """Balance-stripe: water-fill n new rows onto the least-full
        shards (closed form — equivalent to giving each row to the
        current argmin shard, but O(S log range) instead of a per-row
        Python loop). With `room` (per-shard free slots), no shard
        receives more than its room — the at-max-capacity plan; caller
        must check room.sum() >= n first. -> (per-shard index arrays
        into the batch, max rows any shard receives)."""
        c = self._counts
        if room is None:
            room = np.full(self.n_shards, n, dtype=np.int64)
        lo, hi = int(c.min()), int(c.max()) + n
        while lo < hi:  # largest level L with fill-cost <= n
            mid = (lo + hi + 1) // 2
            if int(np.minimum(np.maximum(c, mid) - c, room).sum()) <= n:
                lo = mid
            else:
                hi = mid - 1
        adds = np.minimum(np.maximum(c, lo) - c, room)
        left = n - int(adds.sum())
        if left > 0:  # one extra row each to the lowest-fill shards with room
            eligible = np.nonzero(adds < room)[0]
            order = eligible[np.argsort((c + adds)[eligible], kind="stable")]
            adds[order[:left]] += 1
        bounds = np.concatenate([[0], np.cumsum(adds)]).astype(np.int64)
        per_shard = [np.arange(bounds[s], bounds[s + 1])
                     for s in range(self.n_shards)]
        return per_shard, int(adds.max())

    def _plan_insert(self, n: int) -> tuple[list[np.ndarray], int]:
        """Stripe plan + capacity management: grow shards when the plan
        needs it; when growth is capped (max_capacity), re-plan within
        each shard's remaining room. Raises only when the rows genuinely
        don't fit anywhere (sum of free slots < n)."""
        per_shard, max_rows = self._stripe_plan(n)
        adds = np.array([len(p) for p in per_shard], np.int64)
        needed = int((self._counts + adds).max())
        if needed > self.cap_per_shard:
            try:
                self._grow(needed)
            except IndexFull:
                pass
            if needed > self.cap_per_shard:
                room = (self.cap_per_shard - self._counts).astype(np.int64)
                free = int(room.sum())
                if free < n:
                    raise IndexFull(
                        f"sharded index full: {n} rows, {free} free slots")
                per_shard, max_rows = self._stripe_plan(n, room=room)
        return per_shard, max_rows

    def add(self, vectors, ids: np.ndarray | None = None) -> np.ndarray:
        rows = np.asarray(vectors.cpu() if isinstance(vectors, torch.Tensor)
                          else vectors, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        n = rows.shape[0]
        if n == 0:
            return np.empty((0,), np.int64)
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        plan = self._prepare_add(rows, np.asarray(ids, np.int64))
        self._commit_add(plan)
        return plan["ids"]

    def _prepare_add(self, rows: np.ndarray, ids: np.ndarray) -> dict:
        """Host half of an insert: quantization, balance-stripe
        planning, per-shard block building (plus any capacity growth,
        recorded as grown_cap so another process can replay it). Split
        from _commit_add so the multihost leader runs this ONCE and
        ships the finished blocks — followers skip straight to the
        device writes (parallel/multihost.py ADD wire). Deterministic
        refusals (IndexFull) raise here, before any device write.
        Blocks are built in the wire dtype (i8 codes, i4 biased nibble
        values), so the multihost payload carries 1 byte/dim for the
        quantized tiers."""
        n = rows.shape[0]
        per_shard, max_rows = self._plan_insert(n)
        max_rows = min(_pow2(max_rows), self.cap_per_shard)

        S, D = self.n_shards, self.dim
        row_np = {"f32": np.float32, "bf16": np.float32, "i8": np.int8,
                  "i4": np.uint8}[self.dtype]
        if self.dtype == "i8":
            absmax = np.abs(rows).max(axis=1)
            scs = np.maximum(absmax, 1e-12) / 127.0
            data = np.clip(np.round(rows / scs[:, None]),
                           -127, 127).astype(np.int8)
        elif self.dtype == "i4":
            # biased nibble values (n, D); the row-block packing is
            # position-dependent and happens in the shard's write
            data, scs = quantize_i4_vals_np(rows)
        row_blocks = np.zeros((S, max_rows, D), row_np)
        scale_blocks = (np.ones((S, max_rows), np.float32)
                        if self._has_scales else None)
        exact_blocks = (np.zeros((S, max_rows, D), np.float16)
                        if self.exact else None)
        id_blocks = np.full((S, max_rows), -1, np.int32)
        starts = np.zeros((S,), np.int32)
        for s in range(S):
            sel = per_shard[s]
            starts[s] = self._counts[s]
            if len(sel):
                row_blocks[s, : len(sel)] = (
                    data[sel] if self._has_scales else rows[sel])
                id_blocks[s, : len(sel)] = ids[sel]
                if scale_blocks is not None:
                    scale_blocks[s, : len(sel)] = scs[sel]
                if exact_blocks is not None:
                    exact_blocks[s, : len(sel)] = rows[sel].astype(np.float16)
        return dict(
            row_blocks=row_blocks, scale_blocks=scale_blocks,
            exact_blocks=exact_blocks, id_blocks=id_blocks,
            lens=np.asarray([len(p) for p in per_shard], np.int32),
            starts=starts, ids=ids, grown_cap=self.cap_per_shard)

    def _commit_add(self, plan: dict) -> None:
        """Device half of an insert: replay any growth the plan recorded,
        then write the plan's blocks (write_planned). Every process of a
        crew runs this with the same plan bytes."""
        if plan["grown_cap"] > self.cap_per_shard:
            self._grow(plan["grown_cap"])

        def take(g: int, n: int):
            return tuple(None if plan[key] is None else _host(plan[key][g, :n])
                         for key in ("row_blocks", "scale_blocks",
                                     "exact_blocks", "id_blocks"))
        self.write_planned(plan["lens"], plan["ids"], take,
                           starts=plan["starts"])

    def plan_insert(self, n: int) -> tuple[list[np.ndarray], np.ndarray]:
        """The stripe plan for n new rows (growing shards as needed; see
        _plan_insert) and the ids they will get."""
        per_shard, _ = self._plan_insert(n)
        return per_shard, np.arange(self._next_id, self._next_id + n,
                                    dtype=np.int64)

    def write_planned(self, lens, ids: np.ndarray, take,
                      starts=None) -> None:
        """Write each of this process's shards' planned rows in place at
        its offset (`starts`, default the shard's fill) and advance the
        counts and the next id. `take(g, n)` gives global shard g's n rows
        as (codes, scales, exact, user ids) tensors on any device. A
        shard with no rows is not touched: the reference's blend-write
        no-op."""
        lens = np.asarray(lens, np.int64)
        starts = self._counts.copy() if starts is None else starts
        for s in range(self.mesh.local_shards):
            g = self._first + s
            n = int(lens[g])
            if n == 0:
                continue
            parts = take(g, n)
            for r in range(len(self._groups)):
                self._write_shard(r, s, int(starts[g]), *parts)
        self._counts += lens
        if len(ids):
            self._next_id = max(self._next_id, int(ids.max()) + 1)

    def _write_shard(self, r: int, s: int, start: int, rows: torch.Tensor,
                     scales, exact, uids) -> None:
        """Rows [start, start + n) of replica r's shard s, in place."""
        dev = self._groups[r][s]
        n = rows.shape[0]
        codes = self._codes[r][s]
        if self.dtype == "i4":
            write_rows_i4(codes, rows.to(dev), start, self._i4_block)
        else:
            codes[start:start + n] = rows.to(dev, codes.dtype)
        if scales is not None:
            self._scales[r][s][start:start + n] = scales.to(dev)
        if exact is not None:
            self._exact[r][s][start:start + n] = exact.to(dev)
        self._ids[r][s][start:start + n] = uids.to(dev)

    def fused_eligible(self) -> bool:
        """Whether each shard's search takes the K2 / K3 select: the
        fused gate on the least-filled shard, and for i4 codes packed in
        blocks of one selector tile."""
        return (scan_select.eligible(int(self._counts.min()),
                                     self.cap_per_shard, self.dim,
                                     self.dtype, self.fused_min_rows)
                and (self.dtype != "i4"
                     or self._i4_block == scan_select.DEFAULT_TN))

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact global top-k -> (distances (B,k) asc, user ids; -1 = empty).

        Host (numpy) queries must be unit-normalized once any shard
        crosses the fused-selector gate (see FlatIndex.search)."""
        d, u, B, k_local, single = self.search_dispatch(queries, k)
        return self.search_finalize(d, u, k, B, k_local, single)

    def search_dispatch(self, queries, k: int):
        """Enqueue every shard's search and the merge; the wait lives in
        search_finalize (the same locking contract as
        FlatIndex.search_dispatch). Across processes the all_gather
        waits for the local shards here."""
        _check_unit_queries(queries, int(self._counts.min()),
                            self.cap_per_shard, self.dim, self.dtype,
                            self.fused_min_rows)
        q = torch.as_tensor(queries).float()
        single = q.ndim == 1
        if single:
            q = q[None, :]
        B = q.shape[0]
        k_local = min(k, self.cap_per_shard)
        kf = self.device_fetch_width(k_local) if self.exact else k_local
        fused = self.fused_eligible()
        G = len(self._groups)
        bg = -(-B // G)
        if bg * G != B:  # pad the batch to the query groups
            q = torch.nn.functional.pad(q, (0, 0, 0, bg * G - B))
        first = self.mesh.first_device
        ds, us = [], []
        for r in range(G):
            qr = q[r * bg:(r + 1) * bg]
            parts = [self._search_shard(r, s, qr, k_local, kf, fused)
                     for s in range(self.mesh.local_shards)]
            all_d = torch.stack([p[0].to(first) for p in parts])
            all_u = torch.stack([p[1].to(first) for p in parts])
            if self._world > 1:
                all_d = _all_gather(all_d, self._world).to(first)
                all_u = _all_gather(all_u, self._world).to(first)
            d, u = merge_shards(all_d, all_u, k_local)
            ds.append(d)
            us.append(u)
        return torch.cat(ds), torch.cat(us), B, k_local, single

    def _search_shard(self, r: int, s: int, q: torch.Tensor, k: int,
                      kf: int, fused: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Replica r's shard s -> (B, k) distances and user ids, on the
        shard's device."""
        dev = self._groups[r][s]
        q = q.to(dev)
        count = int(self._counts[self._first + s])
        codes = self._codes[r][s]
        scales = self._scales[r][s] if self._scales is not None else None
        if fused:
            d, i = scan_select.search_select(codes, scales, q, count, kf)
        else:
            d, i = search_kernel(codes, scales, q, count, kf, self.chunk,
                                 self._i4_block)
        if self.exact:
            d, i = rerank_kernel(self._exact[r][s], q, d, i, k)
        ids = self._ids[r][s]
        uid = torch.where(i >= 0, ids[i.clamp(0, ids.shape[0] - 1).long()],
                          -1)
        return d, uid

    @staticmethod
    def search_finalize(d, u, k: int, B: int, k_local: int, single: bool
                        ) -> tuple[np.ndarray, np.ndarray]:
        d, u = d.cpu().numpy()[:B], u.cpu().numpy()[:B]
        if k_local < k:
            d = np.pad(d, ((0, 0), (0, k - k_local)), constant_values=np.inf)
            u = np.pad(u, ((0, 0), (0, k - k_local)), constant_values=-1)
        d, u = d[:, :k], u[:, :k]
        if single:
            return d[0], u[0]
        return d, u

    # -- persistence (the reference's "sharded" .npz; a reload re-shards
    #    onto whatever mesh the new process has) ---------------------------

    def local_arrays(self) -> dict:
        """This process's shards as host arrays, stacked on a leading
        shard axis: codes (bf16 as int16 patterns), scales, exact, ids.
        A device-to-host copy: run it while no write can land (the
        provider's ingest_gate)."""
        def stack(bufs):  # replica 0's shards
            return None if bufs is None else \
                np.stack([t.cpu().numpy() for t in bufs[0]])

        codes = self._codes
        if self.dtype == "bf16":
            codes = [[t.view(torch.int16) for t in codes[0]]]
        return dict(codes=stack(codes), scales=stack(self._scales),
                    exact=stack(self._exact), ids=stack(self._ids))

    def snapshot_fields(self, arrays: dict) -> dict:
        """The .npz members of a snapshot of every shard's `arrays`
        (local_arrays of each process, concatenated in rank order)."""
        return dict(
            kind="sharded",
            codes=arrays["codes"],
            scales=(arrays["scales"] if arrays["scales"] is not None
                    else np.empty(0)),
            exact=(arrays["exact"] if arrays["exact"] is not None
                   else np.empty(0)),
            ids=arrays["ids"],
            counts=np.array(self._counts),
            next_id=self._next_id,
            dtype=self.dtype,
            dim=self.dim,
            i4_block=self._i4_block or 0)

    def snapshot_descr(self) -> dict | None:
        """bf16 codes go out as 16-bit patterns under numpy's bfloat16
        descr, so the member's bytes equal the reference's."""
        return {"codes": _BF16_DESCR} if self.dtype == "bf16" else None

    def save(self, path: str) -> None:
        self.deferred_save()(path)

    def deferred_save(self):
        """Capture the snapshot now and return a closure that writes the
        .npz (the FlatIndex.deferred_save contract: no write may land
        until it has run). Across processes the capture is a gather
        (parallel/multihost.MultihostShardedIndex.deferred_save)."""
        if self._world > 1:
            raise RuntimeError("a sharded index spanning processes saves "
                               "through its crew (MultihostShardedIndex)")
        fields = self.snapshot_fields(self.local_arrays())
        descr = self.snapshot_descr()

        def write(path: str) -> None:
            _atomic_savez(path, descr=descr, **fields)
        return write

    @classmethod
    def load(cls, path: str, mesh: Mesh | None = None,
             **kwargs) -> "ShardedFlatIndex":
        """Reload onto `mesh`. The saved shards map one to one when the
        shard counts agree; otherwise every row is re-striped through
        add() with its user id. A legacy i4 snapshot (no i4_block key,
        the per-row dim-plane layout) is refused: the provider rebuilds
        from the page store."""
        with np.load(path, allow_pickle=False) as z:
            codes = z["codes"]  # (S0, cap, D); i4: (S0, cap/2, D)
            scales = z["scales"]
            exact = z["exact"] if "exact" in z.files else np.empty(0)
            ids = z["ids"]
            counts = z["counts"].astype(np.int64)
            dtype = str(z["dtype"])
            dim = int(z["dim"])
            next_id = int(z["next_id"])
            snap_block = int(z["i4_block"]) if "i4_block" in z.files else 0
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"snapshot dtype {dtype} is not served; the "
                             "provider rebuilds from the page store")
        if dtype == "i4" and snap_block == 0:
            raise ValueError(
                "sharded i4 snapshot in the legacy per-row dim-plane layout "
                "(no i4_block) is not migrated; the provider rebuilds from "
                "the page store")
        if dtype == "bf16":
            codes = np.ascontiguousarray(codes).view(np.int16)
        has_exact = exact.size > 0
        S0 = codes.shape[0]
        cap0 = codes.shape[1] * (2 if dtype == "i4" else 1)
        kwargs.setdefault("segment", cap0)  # keep the saved capacity
        kwargs.setdefault("exact", "f16" if has_exact else None)
        idx = cls(mesh=mesh, dim=dim, dtype=dtype,
                  capacity_per_shard=cap0, **kwargs)
        if dtype == "i4" and snap_block != idx._i4_block:
            # repack every shard into idx's row-block layout
            vals = (unpack_i4_np(codes.reshape(-1, dim), snap_block)
                    .astype(np.int16) + 8).astype(np.uint8)
            codes = pack_i4_np(vals, idx._i4_block).reshape(S0, cap0 // 2,
                                                           dim)
        if idx.n_shards == S0:
            if not has_exact and idx.exact == "f16":
                # a requested shadow the snapshot lacks: backfill it from
                # the dequantized codes (an all-zero shadow would score
                # every candidate at distance 1)
                if dtype == "i4":
                    deq = (unpack_i4_np(codes.reshape(-1, dim),
                                        idx._i4_block)
                           .astype(np.float32).reshape(S0, cap0, dim)
                           * scales[:, :, None])
                else:
                    deq = codes.astype(np.float32)
                    if dtype == "i8":
                        deq = deq * scales[:, :, None]
                exact, has_exact = deq.astype(np.float16), True
            idx._bind(codes, scales if idx._has_scales else None,
                      exact if (has_exact and idx.exact) else None, ids)
            idx._counts = counts
        else:  # re-stripe through the normal insert path
            all_ids, all_rows = [], []
            for s in range(S0):
                n = int(counts[s])
                all_ids.append(ids[s, :n].astype(np.int64))
                if has_exact:
                    rows = exact[s, :n].astype(np.float32)
                elif dtype == "i4":
                    rows = (unpack_i4_np(codes[s], idx._i4_block)
                            [:n].astype(np.float32)
                            * scales[s, :n, None])
                elif dtype == "bf16":
                    rows = torch.from_numpy(codes[s, :n].copy()).view(
                        torch.bfloat16).float().numpy()
                else:
                    rows = codes[s, :n].astype(np.float32)
                    if dtype == "i8":
                        rows = rows * scales[s, :n, None]
                all_rows.append(rows)
            if all_rows:
                idx.add(np.concatenate(all_rows),
                        ids=np.concatenate(all_ids))
        idx._next_id = max(idx._next_id, next_id)
        return idx

    def _bind(self, codes, scales, exact, ids) -> None:
        """Take this process's shards of a snapshot's (S, ...) arrays,
        on every replica's devices."""
        tdt = _TORCH_DTYPES[self.dtype]

        def put(a, dtype, dev):
            t = _host(a)
            if self.dtype == "bf16" and dtype == tdt:
                return t.to(dev).view(torch.bfloat16)
            return t.to(dev, dtype)

        L = self.mesh.local_shards
        rng = range(self._first, self._first + L)
        self._codes = [[put(codes[g], tdt, d) for g, d in zip(rng, group)]
                       for group in self._groups]
        if scales is not None:
            self._scales = [[put(scales[g], torch.float32, d)
                             for g, d in zip(rng, group)]
                            for group in self._groups]
        if exact is not None:
            self._exact = [[put(exact[g], torch.float16, d)
                            for g, d in zip(rng, group)]
                           for group in self._groups]
        self._ids = [[put(ids[g], torch.int32, d) for g, d in zip(rng, group)]
                     for group in self._groups]
