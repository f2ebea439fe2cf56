"""SentenceEncoder: tokenize -> bucketed forward -> pooled unit vectors.

Port of dawnsearch_tpu/models/encoder.py (the serving-side replacement
for the reference's EmbeddingProvider, embedding_service.rs:49-140).
Sequence lengths and batch sizes are bucketed to the same small grids,
and padding rows are a bare [CLS][SEP] (`<s></s>` in an MPNet vocab;
encoder.py:129-133), so both packages see identical (input_ids, mask)
arrays for the same texts; a tokenizer with no leading special (Qwen3's
`$A <|endoftext|>`) pads with its closing one alone. The model is the
config's family (FAMILIES): MPNetModel for model_type "mpnet",
ModernBertModel, Qwen3Model (which pools its own last token), BertModel
otherwise (bert, roberta). The tokenizer is any of the four with the
same encode contract: WordPiece or byte-level BPE, in Python or native
(models/tokenizer*.py).
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch

from dawnsearch_tpu_torch.models.bert import (
    MINILM_L6, BertConfig, BertModel, Params, encode_batch)
from dawnsearch_tpu_torch.models.modernbert import ModernBertModel
from dawnsearch_tpu_torch.models.mpnet import MPNetModel
from dawnsearch_tpu_torch.models.qwen3 import Qwen3Model
from dawnsearch_tpu_torch.models.tokenizer import WordPieceTokenizer
from dawnsearch_tpu_torch.models.tokenizer_bpe import ByteLevelBPETokenizer
from dawnsearch_tpu_torch.models.tokenizer_bpe_native import \
    NativeByteLevelBPETokenizer
from dawnsearch_tpu_torch.models.tokenizer_native import \
    NativeWordPieceTokenizer
from dawnsearch_tpu_torch.utils.logging import METRICS, SPANS, service_logger

log = service_logger("Encoder")

Tokenizer = (WordPieceTokenizer | NativeWordPieceTokenizer
             | ByteLevelBPETokenizer | NativeByteLevelBPETokenizer)

# a grid whose top bucket is past this is a long-context one: its
# dispatches are planned by padded tokens (plan_dispatches)
SHORT_GRID = 512
# padded tokens (B × S, bucketed) a long grid's dispatch may hold: the
# largest dispatch of a 512-token grid, B 1024 × S 512
TOKEN_BUDGET = 1024 * 512
# ... and the model FLOPs of its projections (2·params a token) one
# dispatch may carry: about 2.5 s of a card at 40% of its bf16 peak. It
# binds only past about 1.9 G a token (Qwen3-Embedding-8B's 13.9 G:
# 65,536 tokens); ModernBERT-base's 0.22 G keeps TOKEN_BUDGET
DISPATCH_FLOPS = 10 ** 15
# an insert batch (the ingest pipeline's merge of waiting page batches)
# holds at most this many dispatches' FLOPs of real tokens
INSERT_DISPATCHES = 4


# the model class of each config.json model_type (BertModel otherwise:
# bert, roberta)
FAMILIES = {"mpnet": MPNetModel, "modernbert": ModernBertModel,
            "qwen3": Qwen3Model}


def family(cfg: BertConfig) -> type:
    return FAMILIES.get(cfg.model_type, BertModel)


def projection_flops(cfg: BertConfig) -> int:
    """Model FLOPs of one token's projections through every layer (the
    family's token_flops)."""
    return family(cfg).token_flops(cfg)


def token_budget(cfg: BertConfig, top: int) -> int:
    """Padded tokens a long grid's dispatch may hold: TOKEN_BUDGET, or
    fewer where DISPATCH_FLOPS binds, in whole rows of the top seq bucket
    (at least one)."""
    return min(TOKEN_BUDGET, max(
        top, DISPATCH_FLOPS // projection_flops(cfg) // top * top))


def insert_tokens(cfg: BertConfig) -> int:
    """Real tokens an insert batch of a long grid may hold:
    INSERT_DISPATCHES × DISPATCH_FLOPS of projections."""
    return INSERT_DISPATCHES * DISPATCH_FLOPS // projection_flops(cfg)


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
        document_prompt: str = "",
        query_prompt: str = "",
    ):
        self.model = family(cfg)(cfg, params, device=device)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.seq_buckets = sorted(seq_buckets)
        self.batch_buckets = sorted(batch_buckets)
        self.token_budget = token_budget(cfg, self.seq_buckets[-1])
        # real tokens an insert batch may hold (the ingest pipeline's
        # merge and cut; None: pages alone count)
        self.insert_tokens = (insert_tokens(cfg) if self.long_grid
                              else None)
        self.mask_padding = mask_padding
        self.include_padding_in_pool = include_padding_in_pool
        # put before each page (document) and each query before it is
        # tokenized: a retrieval model's prompts, "" for models without
        self.document_prompt = document_prompt
        self.query_prompt = query_prompt
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

    @property
    def long_grid(self) -> bool:
        return self.seq_buckets[-1] > SHORT_GRID

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Query texts -> (N, H) float32 unit vectors (the query prompt
        put before each)."""
        return self._encode_texts(texts, self.query_prompt)

    def encode_documents(self, texts: Sequence[str]) -> np.ndarray:
        """Page texts -> (N, H) float32 unit vectors (the document prompt
        put before each)."""
        return self._encode_texts(texts, self.document_prompt)

    def _encode_texts(self, texts: Sequence[str], prompt: str) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return self.encode_tokenized(self.tokenize_texts(texts, prompt))

    def plan_dispatches(self, rows: Sequence[int], lengths: Sequence[int],
                        max_batch: int) -> list[list[int]]:
        """`rows` cut into the dispatches that encode them. A grid that
        stops at SHORT_GRID: chunks of max_batch in the given order. A
        long grid: rows sorted by token length (lengths[i] of rows[i]),
        then cut where a chunk would pass max_batch rows or token_budget
        padded tokens (its batch bucket × the seq bucket of its longest
        row; TOKEN_BUDGET, or less where DISPATCH_FLOPS binds)."""
        if not self.long_grid:
            return [list(rows[s:s + max_batch])
                    for s in range(0, len(rows), max_batch)]
        order = sorted(range(len(rows)), key=lambda i: lengths[i])
        out: list[list[int]] = []
        cur: list[int] = []
        for i in order:
            seq = self._bucket(self.seq_buckets, lengths[i])
            n = len(cur) + 1
            if cur and (n > max_batch or self._bucket(
                    self.batch_buckets, n) * seq > self.token_budget):
                out.append(cur)
                cur = []
            cur.append(rows[i])
        if cur:
            out.append(cur)
        return out

    def encode_tokenized(self, ids_list: list[list[int]]) -> np.ndarray:
        """Pre-tokenized id lists -> (N, H) float32 unit vectors. Rows sort
        by length so chunks bucket tightly; every chunk is enqueued before
        the first readback, and order is restored at the end."""
        if not ids_list:
            return np.zeros((0, self.dim), dtype=np.float32)
        order = sorted(range(len(ids_list)), key=lambda i: len(ids_list[i]))
        out = np.zeros((len(ids_list), self.dim), dtype=np.float32)
        pending = []
        for chunk in self.plan_dispatches(
                order, [len(ids_list[i]) for i in order],
                self.batch_buckets[-1]):
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
        padding rows' [CLS][SEP], or closing special, not among them)."""
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
        # Padding rows get a bare [CLS][SEP] (or the closing special alone)
        # so normalization never sees zeros.
        row = self.padding_row()
        input_ids[n:, :len(row)] = row
        mask[n:, :len(row)] = 1
        return input_ids, mask, real

    def padding_row(self) -> list[int]:
        """The ids of a bare row: [CLS][SEP], or a tokenizer's closing
        special alone where its template has no leading one."""
        tok = self.tokenizer
        if getattr(tok, "lead", True):
            return [tok.cls_id, tok.sep_id]
        return [tok.sep_id]

    def tokenize_texts(self, texts: Sequence[str], prompt: str = ""
                       ) -> list[list[int]]:
        """Token ids of `prompt` + each text, cut at the top seq bucket;
        the tokenizer counts what the cut drops in the same pass
        (encoder_texts_truncated, encoder_tokens_truncated)."""
        max_seq = self.seq_buckets[-1]
        out: list[list[int]] = []
        cut = texts_cut = 0
        for t in texts:
            ids, n = self.tokenizer.encode_counted(prompt + t, max_seq)
            out.append(ids)
            if n > max_seq:
                texts_cut += 1
                cut += n - max_seq
        if texts_cut:
            METRICS.inc_many({"encoder_texts_truncated": texts_cut,
                              "encoder_tokens_truncated": cut})
        return out

    def to_device(self, input_ids: np.ndarray, mask: np.ndarray
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self.device
        return (torch.from_numpy(input_ids).to(dev, torch.int64),
                torch.from_numpy(mask).to(dev))

    def dispatch_chunk(self, ids_list: list[list[int]]) -> torch.Tensor:
        """Pad to buckets and enqueue one forward; -> (bsz, H) on device."""
        return self.forward(*self.pad_batch(ids_list))

    def forward(self, input_ids: np.ndarray, mask: np.ndarray
                ) -> torch.Tensor:
        """Enqueue one forward of a padded (B, S) batch; -> (B, H) unit
        vectors on the device, without waiting. While a capture runs, a
        model whose spans count real tokens (host_lengths) also gets the
        rows' lengths from the host."""
        extra = ({"lengths": mask.sum(axis=1)}
                 if SPANS.on and self.model.host_lengths else {})
        if self.model.pools:
            with torch.inference_mode():
                return self.model(*self.to_device(input_ids, mask),
                                  mask_padding=self.mask_padding, **extra)
        return encode_batch(self.model, *self.to_device(input_ids, mask),
                            mask_padding=self.mask_padding,
                            include_padding=self.include_padding_in_pool,
                            **extra)

    def warmup(self, max_batch: int = 256) -> int:
        """Run one forward on every (seq bucket, batch bucket <= max_batch)
        of bare rows (padding_row; dawnsearch_tpu/models/encoder.py:
        146-163), then synchronize once. On a card this builds and loads
        the kernels and grows the caching allocator before the first
        request. Buckets past max_batch (bulk-ingest sizes), and on a long
        grid those past token_budget (no dispatch takes them), are left
        cold. Returns the number of shapes run."""
        shapes = [(bsz, seq) for seq in self.seq_buckets
                  for bsz in self.batch_buckets if bsz <= max_batch
                  and (not self.long_grid or bsz * seq <= self.token_budget)]
        row = self.padding_row()
        for bsz, seq in shapes:
            ids = np.full((bsz, seq), self.tokenizer.pad_id, np.int32)
            ids[:, :len(row)] = row
            mask = np.zeros((bsz, seq), np.int32)
            mask[:, :len(row)] = 1
            self.forward(ids, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log.info("encoder warmup complete (%d shapes)", len(shapes))
        return len(shapes)
