"""Fused query and ingest paths: text -> embedding -> index, on one stream.

Port of dawnsearch_tpu/serving/fused.py (FusedQueryPath, FusedIngestPath).
The reference fuses each path into one jitted program; here each path
enqueues its work on the device's current stream without waiting: the
encoder's K1 launches, then the index search (the K2 or K3 selector at
and above scan_select.MIN_ROWS, the chunked exact search below) or the i8
/ i4 quantize and in-place row write (bf16 indexes ingest through the
provider's add, as in the reference). The caller reads the result back
outside its device lock. ShardedFusedIngestPath is the ingest path of a
ShardedFlatIndex: one encode on the encoder's device, then each shard's
rows are copied to its device and written there. Both ingest paths run
their pages through one pipelined loop (IngestPath.run), in the
dispatches the encoder plans.
"""

from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from dawnsearch_tpu_torch.index.flat import (FlatIndex, quantize_rows_i8,
                                             rerank_kernel, search_kernel)
from dawnsearch_tpu_torch.ops import scan_select
from dawnsearch_tpu_torch.ops.quant import quantize_i4_vals, write_rows_i4
from dawnsearch_tpu_torch.utils.logging import METRICS, service_logger, span

log = service_logger("Search")


@contextmanager
def holding(lock, wait_span: str):
    """Hold `lock`; the wait for it is span `wait_span`."""
    with span(wait_span):
        lock.acquire()
    try:
        yield
    finally:
        lock.release()


def _encode(encoder, input_ids: np.ndarray, mask: np.ndarray,
            real: int) -> torch.Tensor:
    """Enqueue one forward of a padded (B, S) batch holding `real` real
    tokens. Counts encoder_tokens_real and encoder_tokens_padded (B × S,
    padding rows included); span encoder.forward (args B, S, real) while
    a capture runs."""
    B, S = input_ids.shape
    METRICS.inc_many({"encoder_tokens_real": real,
                      "encoder_tokens_padded": B * S})
    with span("encoder.forward", B=B, S=S, real=real):
        return encoder.forward(input_ids, mask)


class FusedQueryPath:
    """Batched text search against a FlatIndex, enqueued in one go."""

    def __init__(self, encoder, index: FlatIndex):
        self.encoder = encoder
        self.index = index

    @staticmethod
    def supports(index) -> bool:
        return isinstance(index, FlatIndex)

    def dispatch(self, texts: list[str], k: int):
        """Enqueue encode + search; returns DEVICE tensors
        (emb, dists, ids) + k_eff without waiting. Caller holds the
        device-state lock for this call only and runs finalize() outside
        it."""
        ix = self.index
        k_eff = min(k, ix.capacity)
        kf = ix.device_fetch_width(k_eff) if ix.device_rerank else k_eff
        with METRICS.timer("fused_query_dispatch"):
            enc = self.encoder
            emb = _encode(enc, *enc.pad_counted(
                enc.tokenize_texts(texts, enc.query_prompt)))
            if ix.fused_eligible():
                d, i = scan_select.search_select(ix._codes, ix._scales, emb,
                                                 ix.count, kf)
            else:
                d, i = search_kernel(ix._codes, ix._scales, emb, ix.count,
                                     kf, ix.chunk, ix._i4_block)
            if ix.device_rerank:
                d, i = rerank_kernel(ix._exact, emb, d, i, k_eff)
        return emb, d, i, k_eff

    @staticmethod
    def finalize(emb, d, i, n: int, k: int, k_eff: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Wait for the enqueued work and shape the host results."""
        emb, d, i = emb.cpu().numpy(), d.cpu().numpy(), i.cpu().numpy()
        if k_eff < k:
            d = np.pad(d, ((0, 0), (0, k - k_eff)), constant_values=np.inf)
            i = np.pad(i, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return emb[:n], d[:n, :k], i[:n, :k]


class IngestPath:
    """What both ingest paths share: the encoder, the index and the
    pipelined ingest loop (run, and ingest on top of it). A subclass adds
    supports() and dispatch(ids_list), which enqueues encode + quantize +
    index write for at most max_batch pages' token ids, advances the
    index's count and returns the (padded) embeddings on the device
    without waiting."""

    def __init__(self, encoder, index):
        self.encoder = encoder
        self.index = index

    @property
    def max_batch(self) -> int:
        """Largest batch dispatch() accepts: the encoder's top batch
        bucket. The extraction pipeline coalesces idle-time batches up to
        about this size."""
        return self.encoder.batch_buckets[-1]

    def run(self, ids, rows: list[int], lock, finish) -> None:
        """Encode and write the pages `rows` (ids[i] holds page i's token
        ids) in the dispatches the encoder plans. Each dispatch is
        enqueued holding `lock` (span ingest.dispatch, args pages and
        part), with base = len(index) taken before it. Dispatches are
        pipelined one deep: sub-batch i+1 is enqueued before
        finish(sub, emb_dev, base, part) reads sub-batch i back, hiding
        the fixed dispatch cost. If anything fails, every sub-batch
        already dispatched is still finished before the error propagates:
        its device rows have landed, so the store must take them too."""
        plan = self.encoder.plan_dispatches(
            rows, [len(ids[i]) for i in rows], self.max_batch)
        pending: deque = deque()  # dispatched, not yet finished
        try:
            for part, sub in enumerate(plan):
                with holding(lock, "ingest.lock.wait"), \
                        span("ingest.dispatch", pages=len(sub), part=part):
                    base = len(self.index)
                    emb_dev = self.dispatch([ids[i] for i in sub])
                pending.append((sub, emb_dev, base, part))
                if len(pending) > 1:
                    finish(*pending.popleft())
            while pending:
                finish(*pending.popleft())
        except BaseException:
            while pending:
                try:
                    finish(*pending.popleft())
                except Exception:
                    log.exception(
                        "in-flight sub-batch store failed during ingest "
                        "error unwind (store/index may diverge; next "
                        "insert will reconcile)")
            raise

    def ingest(self, texts: list[str],
               token_ids: list[list[int]] | None = None) -> np.ndarray:
        """Embed + append `texts` to the index through run(); returns (n,
        H) f32 embeddings in input order (on a long grid the index rows
        follow the encoder's length-sorted plan). Caller must hold the
        provider lock."""
        enc = self.encoder
        ids = (token_ids if token_ids is not None
               else enc.tokenize_texts(texts, enc.document_prompt))
        out = np.zeros((len(texts), enc.dim), np.float32)

        def finish(sub, emb_dev, base, part):
            with METRICS.timer("fused_ingest"):
                out[sub] = emb_dev[: len(sub)].cpu().numpy()

        self.run(ids, list(range(len(texts))), threading.Lock(), finish)
        return out


class FusedIngestPath(IngestPath):
    """Batched page ingest against an i8 or i4 FlatIndex: encode ->
    quantize -> write rows in place (and the f16 shadow, when kept). i4
    rows go through the row-block read-modify-write at `count`
    (ops/quant.write_rows_i4)."""

    @staticmethod
    def supports(index) -> bool:
        return isinstance(index, FlatIndex) and index.dtype in ("i8", "i4")

    def dispatch(self, ids_list: list[list[int]]) -> torch.Tensor:
        """Enqueue encode + quantize + index write for one bucket-sized
        batch (len(ids_list) <= max_batch); bumps count and returns the
        (padded) embeddings on the device without waiting. Caller holds
        the device-state lock for this call and reads the result back
        outside it. Rows past n in the padded batch are written too: they
        sit past `count`, are masked out of every search, and the next
        insert overwrites them."""
        enc = self.encoder
        ix = self.index
        n = len(ids_list)
        input_ids, mask, real = enc.pad_counted(ids_list)
        bsz = input_ids.shape[0]
        if ix.max_capacity is not None:
            # Scratch rows (batch padding past n) must also fit. Near
            # max_capacity a legitimate n-page insert can need
            # count+bsz > the growable ceiling — encode, then add only
            # the n valid rows, rather than fail a batch that fits.
            ceiling = -(-ix.max_capacity // ix.segment) * ix.segment
            if ix.count + bsz > ceiling and ix.count + n <= ix.max_capacity:
                emb = enc.encode_tokenized(ids_list)
                ix.add(emb)
                return torch.from_numpy(emb)
        if ix.count + bsz > ix.capacity:  # reserve scratch rows too
            ix._grow_to(ix.count + bsz)
        with METRICS.timer("fused_ingest_dispatch"):
            emb = _encode(enc, input_ids, mask, real)
            s, e = ix.count, ix.count + emb.shape[0]
            if ix.dtype == "i4":
                vals, scales = quantize_i4_vals(emb)
                write_rows_i4(ix._codes, vals, s, ix._i4_block)
            else:
                codes, scales = quantize_rows_i8(emb)
                ix._codes[s:e] = codes
            ix._scales[s:e] = scales
            if ix.device_rerank:
                ix._exact[s:e] = emb.half()
        ix.count += n
        return emb


class ShardedFusedIngestPath(IngestPath):
    """Batched page ingest against an i8 or i4 ShardedFlatIndex (reference
    serving/fused.py::ShardedFusedIngestPath): encode once on the
    encoder's device (K1), quantize there (i8 codes, or i4 nibble values
    and scales), then copy each shard's rows, as the index's stripe plan
    assigns them, to the shard's device and write them in place at the
    shard's fill. A shard that receives no rows is not written."""

    @staticmethod
    def supports(index) -> bool:
        from dawnsearch_tpu_torch.parallel.sharded_index import \
            ShardedFlatIndex
        return (isinstance(index, ShardedFlatIndex)
                and index.dtype in ("i8", "i4"))

    def dispatch(self, ids_list: list[list[int]]) -> torch.Tensor:
        """Enqueue encode + quantize + every shard's write for one
        bucket-sized batch; advances the counts and returns the (padded)
        embeddings on the encoder's device without waiting (the
        FusedIngestPath.dispatch contract)."""
        enc = self.encoder
        ix = self.index
        # grows shards as needed; at max_capacity it re-plans within each
        # shard's room and raises only when the rows fit nowhere
        per_shard, uids = ix.plan_insert(len(ids_list))
        with METRICS.timer("fused_ingest_dispatch"):
            emb = _encode(enc, *enc.pad_counted(ids_list))
            if ix.dtype == "i4":
                codes, scales = quantize_i4_vals(emb)
            else:
                codes, scales = quantize_rows_i8(emb)
            f16 = emb.half() if ix.exact else None

            def take(g: int, _n: int):
                sel = torch.from_numpy(per_shard[g]).to(emb.device)
                return (codes[sel], scales[sel],
                        None if f16 is None else f16[sel],
                        torch.from_numpy(uids[per_shard[g]].astype(np.int32)))
            ix.write_planned([len(p) for p in per_shard], uids, take)
        return emb
