"""Fused query and ingest paths: text -> embedding -> index, on one stream.

Port of dawnsearch_tpu/serving/fused.py (FusedQueryPath, FusedIngestPath,
_chunk_by_bucket). The reference fuses each path into one jitted program;
here each path enqueues its work on the device's current stream without
waiting: the encoder's K1 launches, then the index search (the K2 or K3
selector at and above scan_select.MIN_ROWS, the chunked exact search
below) or the i8 / i4 quantize and in-place row write (bf16 indexes ingest
through the provider's add, as in the reference). The caller reads the
result back outside its device lock. ShardedFusedIngestPath is the
ingest path of a ShardedFlatIndex: one encode on the encoder's device,
then each shard's rows are copied to its device and written there.
"""

from __future__ import annotations

import numpy as np
import torch

from dawnsearch_tpu_torch.index.flat import (FlatIndex, quantize_rows_i8,
                                             rerank_kernel, search_kernel)
from dawnsearch_tpu_torch.models.bert import encode_batch
from dawnsearch_tpu_torch.ops import scan_select
from dawnsearch_tpu_torch.ops.quant import quantize_i4_vals, write_rows_i4
from dawnsearch_tpu_torch.utils.logging import METRICS, SPANS, span


def _encode(encoder, input_ids: np.ndarray, mask: np.ndarray,
            real: int) -> torch.Tensor:
    """Enqueue one forward of a padded (B, S) batch holding `real` real
    tokens. Counts encoder_tokens_real and encoder_tokens_padded (B × S,
    padding rows included); span encoder.forward (args B, S, real) while
    a capture runs; a long-context model (ModernBERT) then also gets the
    rows' real lengths from the host, for its spans' args."""
    B, S = input_ids.shape
    METRICS.inc_many({"encoder_tokens_real": real,
                      "encoder_tokens_padded": B * S})
    extra = {}
    if SPANS.on and getattr(encoder.model, "LONG", False):
        extra["lengths"] = mask.sum(axis=1)
    with span("encoder.forward", B=B, S=S, real=real):
        input_ids, mask = encoder.to_device(input_ids, mask)
        return encode_batch(encoder.model, input_ids, mask,
                            mask_padding=encoder.mask_padding,
                            include_padding=encoder.include_padding_in_pool,
                            **extra)


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


def _chunk_by_bucket(ingest_fn, encoder, texts, token_ids):
    """Split a batch at the encoder's largest batch bucket and recurse
    through `ingest_fn` — any caller-chosen ingest batch size is safe
    regardless of the bucket grid. Returns None when no split needed."""
    maxb = getattr(encoder, "batch_buckets", [len(texts)])[-1]
    if len(texts) <= maxb:
        return None
    outs = []
    for s in range(0, len(texts), maxb):
        tk = token_ids[s:s + maxb] if token_ids is not None else None
        outs.append(ingest_fn(texts[s:s + maxb], token_ids=tk))
    return np.concatenate(outs)


def plans_by_length(path) -> bool:
    """The ingest path's encoder has a long grid: plan_ingest wants the
    pages' token ids."""
    return getattr(path.encoder, "long_grid", False)


def plan_ingest(path, rows: list[int], token_ids) -> list[list[int]]:
    """`rows` (indexes of a batch's pages, whose ids are token_ids[i]) cut
    into the sub-batches an ingest path's dispatch() takes: chunks of its
    max_batch in order, or on a long grid by padded tokens
    (SentenceEncoder.plan_dispatches)."""
    maxb = path.max_batch or max(len(rows), 1)
    plan = getattr(path.encoder, "plan_dispatches", None)
    if plan is None or token_ids is None:
        return [rows[s:s + maxb] for s in range(0, len(rows), maxb)]
    return plan(rows, [len(token_ids[i]) for i in rows], maxb)


class FusedIngestPath:
    """Batched page ingest against an i8 or i4 FlatIndex: encode ->
    quantize -> write rows in place (and the f16 shadow, when kept). i4
    rows go through the row-block read-modify-write at `count`
    (ops/quant.write_rows_i4)."""

    def __init__(self, encoder, index: FlatIndex):
        self.encoder = encoder
        self.index = index

    @staticmethod
    def supports(index) -> bool:
        return isinstance(index, FlatIndex) and index.dtype in ("i8", "i4")

    @property
    def max_batch(self) -> int | None:
        """Largest batch dispatch() accepts (the encoder's top batch
        bucket); None = unbounded. Serving loops sub-batch at this size
        so searches can interleave between ingest dispatches."""
        buckets = getattr(self.encoder, "batch_buckets", None)
        return buckets[-1] if buckets else None

    def dispatch(self, texts: list[str],
                 token_ids: list[list[int]] | None = None) -> torch.Tensor:
        """Enqueue encode + quantize + index write for one bucket-sized
        batch (len(texts) <= max_batch); bumps count and returns the
        (padded) embeddings on the device without waiting. Caller holds
        the device-state lock for this call and reads the result back
        outside it. Rows past n in the padded batch are written too: they
        sit past `count`, are masked out of every search, and the next
        insert overwrites them."""
        enc = self.encoder
        ids_list = (token_ids if token_ids is not None
                    else enc.tokenize_texts(texts, enc.document_prompt))
        ix = self.index
        n = len(texts)
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

    def ingest(self, texts: list[str],
               token_ids: list[list[int]] | None = None) -> np.ndarray:
        """Embed + append `texts` to the index; returns (n, H) f32
        embeddings for durable storage. Caller must hold the provider
        lock."""
        chunked = _chunk_by_bucket(self.ingest, self.encoder, texts, token_ids)
        if chunked is not None:
            return chunked
        with METRICS.timer("fused_ingest"):
            emb = self.dispatch(texts, token_ids=token_ids).cpu().numpy()
        return emb[: len(texts)]


class ShardedFusedIngestPath:
    """Batched page ingest against an i8 or i4 ShardedFlatIndex (reference
    serving/fused.py::ShardedFusedIngestPath): encode once on the
    encoder's device (K1), quantize there (i8 codes, or i4 nibble values
    and scales), then copy each shard's rows, as the index's stripe plan
    assigns them, to the shard's device and write them in place at the
    shard's fill. A shard that receives no rows is not written."""

    def __init__(self, encoder, index):
        self.encoder = encoder
        self.index = index

    @staticmethod
    def supports(index) -> bool:
        from dawnsearch_tpu_torch.parallel.sharded_index import \
            ShardedFlatIndex
        return (isinstance(index, ShardedFlatIndex)
                and index.dtype in ("i8", "i4"))

    @property
    def max_batch(self) -> int | None:
        buckets = getattr(self.encoder, "batch_buckets", None)
        return buckets[-1] if buckets else None

    def dispatch(self, texts: list[str],
                 token_ids: list[list[int]] | None = None) -> torch.Tensor:
        """Enqueue encode + quantize + every shard's write for one
        bucket-sized batch; advances the counts and returns the (padded)
        embeddings on the encoder's device without waiting (the
        FusedIngestPath.dispatch contract)."""
        enc = self.encoder
        ix = self.index
        n = len(texts)
        ids_list = (token_ids if token_ids is not None
                    else enc.tokenize_texts(texts, enc.document_prompt))
        # grows shards as needed; at max_capacity it re-plans within each
        # shard's room and raises only when the rows fit nowhere
        per_shard, uids = ix.plan_insert(n)
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

    def ingest(self, texts: list[str],
               token_ids: list[list[int]] | None = None) -> np.ndarray:
        """Embed + stripe-append `texts` across the shards; returns (n, H)
        f32 embeddings for durable storage. Caller must hold the provider
        lock."""
        chunked = _chunk_by_bucket(self.ingest, self.encoder, texts, token_ids)
        if chunked is not None:
            return chunked
        with METRICS.timer("fused_ingest"):
            emb = self.dispatch(texts, token_ids=token_ids).cpu().numpy()
        return emb[: len(texts)]
