"""SentenceEncoder: tokenize -> bucketed forward -> pooled unit vectors.

Port of dawnsearch_tpu/models/encoder.py (the serving-side replacement
for the reference's EmbeddingProvider, embedding_service.rs:49-140).
Sequence lengths and batch sizes are bucketed to the same small grids,
and padding rows are a bare [CLS][SEP] (`<s></s>` in an MPNet vocab;
encoder.py:129-133), so both packages see identical (input_ids, mask)
arrays for the same texts. The model is the config's family: MPNetModel
for model_type "mpnet", BertModel otherwise (bert, roberta). The tokenizer
is any of the four with the same encode contract: WordPiece or byte-level
BPE, in Python or native (models/tokenizer*.py).
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch

from dawnsearch_tpu_torch.models.bert import (
    MINILM_L6, BertConfig, BertModel, Params, encode_batch)
from dawnsearch_tpu_torch.models.mpnet import MPNetModel
from dawnsearch_tpu_torch.models.tokenizer import WordPieceTokenizer
from dawnsearch_tpu_torch.models.tokenizer_bpe import ByteLevelBPETokenizer
from dawnsearch_tpu_torch.models.tokenizer_bpe_native import \
    NativeByteLevelBPETokenizer
from dawnsearch_tpu_torch.models.tokenizer_native import \
    NativeWordPieceTokenizer
from dawnsearch_tpu_torch.utils.logging import service_logger

log = service_logger("Encoder")

Tokenizer = (WordPieceTokenizer | NativeWordPieceTokenizer
             | ByteLevelBPETokenizer | NativeByteLevelBPETokenizer)


class SentenceEncoder:
    def __init__(
        self,
        params: Params,
        tokenizer: Tokenizer,
        cfg: BertConfig = MINILM_L6,
        seq_buckets: Sequence[int] = (16, 32, 64, 128, 256, 512),
        batch_buckets: Sequence[int] = (1, 8, 32, 64, 128, 256, 512, 1024),
        mask_padding: bool = True,
        include_padding_in_pool: bool = False,
        *,
        device,
    ):
        family = MPNetModel if cfg.model_type == "mpnet" else BertModel
        self.model = family(cfg, params, device=device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.seq_buckets = sorted(seq_buckets)
        self.batch_buckets = sorted(batch_buckets)
        self.mask_padding = mask_padding
        self.include_padding_in_pool = include_padding_in_pool
        if self.seq_buckets[-1] > cfg.max_position_embeddings:
            raise ValueError("seq bucket exceeds max_position_embeddings")

    @property
    def dim(self) -> int:
        return self.cfg.hidden_size

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _bucket(self, buckets: list[int], n: int) -> int:
        i = bisect.bisect_left(buckets, n)
        return buckets[min(i, len(buckets) - 1)]

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Texts -> (N, H) float32 unit vectors."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return self.encode_tokenized(self.tokenize_texts(texts))

    def encode_tokenized(self, ids_list: list[list[int]]) -> np.ndarray:
        """Pre-tokenized id lists -> (N, H) float32 unit vectors. Rows sort
        by length so chunks bucket tightly; every chunk is enqueued before
        the first readback, and order is restored at the end."""
        if not ids_list:
            return np.zeros((0, self.dim), dtype=np.float32)
        order = sorted(range(len(ids_list)), key=lambda i: len(ids_list[i]))
        out = np.zeros((len(ids_list), self.dim), dtype=np.float32)
        max_batch = self.batch_buckets[-1]
        pending = []
        for start in range(0, len(order), max_batch):
            chunk = order[start: start + max_batch]
            pending.append(
                (chunk, self.dispatch_chunk([ids_list[i] for i in chunk])))
        for chunk, vecs in pending:
            out[chunk] = vecs[: len(chunk)].cpu().numpy()
        return out

    def pad_batch(self, ids_list: list[list[int]]
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Token id lists -> bucketed (input_ids, mask) arrays."""
        return self.pad_counted(ids_list)[:2]

    def pad_counted(self, ids_list: list[list[int]]
                    ) -> tuple[np.ndarray, np.ndarray, int]:
        """pad_batch, and the number of real tokens it placed (the
        padding rows' [CLS][SEP] not among them)."""
        n = len(ids_list)
        if n > self.batch_buckets[-1]:
            raise ValueError(
                f"batch of {n} exceeds the top batch bucket "
                f"{self.batch_buckets[-1]}; chunk it (see encode())")
        seq = self._bucket(self.seq_buckets, max(len(ids) for ids in ids_list))
        bsz = self._bucket(self.batch_buckets, n)
        pad_id = self.tokenizer.pad_id
        input_ids = np.full((bsz, seq), pad_id, dtype=np.int32)
        mask = np.zeros((bsz, seq), dtype=np.int32)
        real = 0
        for r, ids in enumerate(ids_list):
            ids = ids[:seq]
            input_ids[r, : len(ids)] = ids
            mask[r, : len(ids)] = 1
            real += len(ids)
        # Padding rows get a bare [CLS][SEP] so normalization never sees zeros.
        for r in range(n, bsz):
            input_ids[r, 0] = self.tokenizer.cls_id
            input_ids[r, 1] = self.tokenizer.sep_id
            mask[r, :2] = 1
        return input_ids, mask, real

    def tokenize_texts(self, texts: Sequence[str]) -> list[list[int]]:
        max_seq = self.seq_buckets[-1]
        return [self.tokenizer.encode(t, max_len=max_seq) for t in texts]

    def to_device(self, input_ids: np.ndarray, mask: np.ndarray
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self.device
        return (torch.from_numpy(input_ids).to(dev, torch.int64),
                torch.from_numpy(mask).to(dev))

    def dispatch_chunk(self, ids_list: list[list[int]]) -> torch.Tensor:
        """Pad to buckets and enqueue one forward; -> (bsz, H) on device."""
        return self._forward(*self.pad_batch(ids_list))

    def _forward(self, input_ids: np.ndarray, mask: np.ndarray
                 ) -> torch.Tensor:
        return encode_batch(self.model, *self.to_device(input_ids, mask),
                            mask_padding=self.mask_padding,
                            include_padding=self.include_padding_in_pool)

    def warmup(self, max_batch: int = 256) -> int:
        """Run one forward on every (seq bucket, batch bucket <= max_batch)
        of bare [CLS][SEP] rows (dawnsearch_tpu/models/encoder.py:146-163),
        then synchronize once. On a card this builds and loads the kernels
        and grows the caching allocator before the first request. Buckets
        past max_batch (bulk-ingest sizes) are left cold. Returns the
        number of shapes run."""
        shapes = [(bsz, seq) for seq in self.seq_buckets
                  for bsz in self.batch_buckets if bsz <= max_batch]
        for bsz, seq in shapes:
            ids = np.full((bsz, seq), self.tokenizer.pad_id, np.int32)
            ids[:, 0] = self.tokenizer.cls_id
            ids[:, 1] = self.tokenizer.sep_id
            mask = np.zeros((bsz, seq), np.int32)
            mask[:, :2] = 1
            self._forward(ids, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.info("encoder warmup complete (%d shapes)", len(shapes))
        return len(shapes)
