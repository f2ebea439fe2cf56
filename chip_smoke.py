#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (dawnsearch_tpu_torch) once on one GPU.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases build,k1,k4,k2
    python3 chip_smoke.py --phases k3,k2bf16,recall_i4,i4_scale
    python3 chip_smoke.py --phases attn,ffn,pool,ops   # the per-op encoder
    python3 chip_smoke.py --phases build,k1,k4,attn,ffn,node  # f32 entries
    python3 chip_smoke.py --phases build,swarm   # ingest and the UDP swarm
    python3 chip_smoke.py --phases build,sharded,node,crew --node-runs sharded
    python3 chip_smoke.py --phases build,k1,attn,ops,node \
        --node-runs f32,f32-k4,f32-ops,mpnet-f32          # the f32 routes

Phases, each printing one progress line; any failure exits non-zero:
  device    card name and power limit (nvidia-smi); fails without CUDA
  build     g++ builds the native library (native/*.cpp: the WordPiece
            and byte-level BPE tokenizers, the HTML extractor and the
            English filter) and, apart, the WARC parser (native/warc.cpp,
            -lz; a failure there is printed and leaves ingest the Python
            reader), and nvcc builds csrc/*.cu (one nvcc per source, in
            parallel), all into dawnsearch_tpu_torch/_build/; prints each
            build's time and ptxas' registers
  k1        whole-layer kernel vs bert_layer_plain, bf16, ragged masks: at
            MiniLM width (H=384, hd 32) at (B, S) = (64, 128), (8, 512) and
            (64, 16: short queries), at BERT-base width (H=768, hd 64,
            I=3072) at (64, 128) and BERT-large width (H=1024, 16 heads of
            64, I=4096) at (8, 512); timed, beside torch's
            TransformerEncoderLayer fast path on the same weights (the
            library yardstick); each of its four GEMMs alone at each of
            those shapes and at M = 128 of each width, against the f32
            product, timed beside torch.addmm; then K1 with MPNet's
            rel_bias (a seeded (32, nh) table gathered by the port's
            position_bias) at all-mpnet-base-v2's width at (64, 128) and
            (8, 512), timed
            beside K1 without it and beside the library layer with rel and
            the key mask as one float src_mask; then the same in f32 (K1's
            f32 instance, compute_dtype = "f32": 3xTF32, its weights as
            (W_hi, W_lo) pairs) at MiniLM and BERT-base (64, 128) and with
            rel_bias at both MPNet shapes, against the twin and the library
            layer in f32 with TF32 off, and its four f32 GEMMs alone at
            MiniLM and BERT-base widths at M = 8192 and 128 against the f64
            product, timed beside torch.addmm in f32
  k4        the W8A8 whole-layer kernel vs bert_layer_i8_plain with ragged
            masks at MiniLM and BERT-base widths (64, 128) and (1, 128)
            and BERT-large (8, 512), each timed beside K1 on the same
            weights, its device time split by launch (torch.profiler);
            its four s8 GEMMs alone at M = 8192 / 4096 and 128, against
            the twin's arithmetic, beside torch._int_mm; K4 with rel_bias
            at all-mpnet-base-v2's width at (64, 128) and (8, 512), timed
            beside K4 without it; K4's f32 instance at MiniLM and
            BERT-base (64, 128) and BERT-base (1, 128) beside K1's; then
            12-layer BERT-base and MPNet-base encode_batch on K1 and on
            K4, device time at B = 1 and 64, S = 128
  k2        i8 score+select vs select_candidates_plain at 1,048,576 x 384
            codes and 1024 queries, and at B = 1, 8 and 32 over the node's
            index (capacity 524,288, 270,000 live rows) and over 1,048,576
            rows: values and ids bit-equal; timed (the small batches as
            CUDA-graph replays)
  k3        i4 score+select (K3) at 1,048,576 logical rows (201 MB packed)
            and 1024 queries and at B = 1, 8 and 32 over the node's index:
            qi8 values and ids bit-equal to the plain twin, qi8=False
            (1024 queries) within the bf16 tolerance; timed
  k2bf16    K2 over bf16 codes (805 MB) and K2 i8 with qi8=False, 1024
            queries, within the bf16 tolerance; timed
  attn      K5 (packed: q, k, v as column slices of one (B, S, 3H) qkv)
            and K6 (head-major) vs their plain twins in bf16 with ragged
            masks: K5 at MiniLM width at (B, S) = (64, 128), (8, 512),
            (64, 16) and at BERT-base width (H=768, hd 64) at (64, 128);
            K6 at the same shapes and at hd 26 (TinyBERT, H=312) at
            (64, 128) and (8, 512); then each at its first two shapes in
            f32; timed beside torch's scaled_dot_product_attention in the
            same dtype (the library yardstick)
  ffn       K7 (two launches of the GEMM ring, csrc/ffn.cu + csrc/gemm.cuh)
            vs ffn_plain at 8192 rows for MiniLM (384/1536), BERT-base
            (768/3072) and TinyBERT (312/1200: ragged tiles) widths, and at
            128 rows (one query) at MiniLM and BERT-base widths; in f32
            (3xTF32, W as tf32_pair pairs) at 8192 rows of MiniLM and
            BERT-base and at 128 rows of both; timed beside the PyTorch
            composition of the same function (addmm, GELU, addmm, + x,
            layer_norm: five calls in the entry's dtype, TF32 off)
  pool      K8 vs mean_pool_plain in bf16 and f32 with the encoder's
            int32 mask at (B, S, H) = (64, 128, 384) (also
            include_padding), (1, 128, 384), (8, 128, 384), (8, 512, 384),
            (8, 512, 1024) and (8, 512, 2048): its bf16 result bit-equal to
            its f32 one on the upcast input, two calls bit-equal; timed
            beside the pool_impl="xla" composition and a launch floor; then
            encode_batch's pool stage on a bf16 (B, 128, 384) last hidden
            state at B = 1, 8, 64: K8 alone, the cast route (casts + K8
            f32) and the xla route, device and host time
  recall    FlatIndex i8 at 1,048,576 seeded unit rows, 1024 queries,
            recall@10 raw and after the f32 re-rank of k+30 candidates
  recall_i4 FlatIndex i4 at 2,097,152 rows built through host-packed adds
            (re-rank at the i4 ladder's 256 candidates) and FlatIndex
            bf16 at 1,048,576 rows (k+30)
  i4_scale  a 67,108,864-row i4 index (12.9 GB of codes) filled by device
            adds, searched at B=1 and B=1024, a planted row at rank 1
  profile   where a text query's time goes on the node's default path
            (FusedQueryPath over 270,000 i8 rows): host-timed tokenize (the
            node's native tokenizer, beside the pure-Python one on the same
            texts, ids equal), encode, select and whole query at B=1, 8,
            64, and the device busy share and top kernels from
            torch.profiler
  ops       the encoder end to end through SentenceEncoder on the smoke
            texts, each run against the same encoder on the CPU: MiniLM
            width with layer_impl="layer" (K1; pool "xla" and "fused"),
            "layer_i8" (K4) and "ops" (pool "fused" and "xla") and with
            attn_impl="xla", TinyBERT width (H=312,
            12 heads, I=1200, 4 layers) with layer_impl="layer", which must
            fall back to K6 + K7, and all-mpnet-base-v2's width (2 layers)
            with layer_impl="ops", which must run K7 and never K5 or K6
            (einsum attention under the position bias), and
            all-distilroberta-v1's width (2 layers, its byte-level BPE
            tokenizer, native) with layer_impl="layer" (K1); then in f32 the
            MiniLM K1 and per-op (K8 pool) routes and the TinyBERT
            fallback (K6 + K7 f32), within the f32 atol 1e-4 of the CPU;
            the counters each run raised (every other encoder counter must
            stay 0); encode ms
            at B=1, 8, 64 (S=128) on the K1 path (both pools) and the
            per-op paths, bf16 and
            f32, as device time (CUDA-graph replays) and as host time over
            6 alternating rounds (median [min, max])
  sharded   ShardedFlatIndex, 4 shards on cuda:0, over 1,048,576 seeded
            unit rows (262,144 a shard, the K2 gate), i8 and i4 with the
            f16 shadow, against a FlatIndex over the same rows at B = 1, 8
            and 32 (queries near planted rows): every shard's K2 / K3
            select bit-equal to its plain twin, the planted row first, the
            top-10 ids raw and after the f16 re-rank equal to the flat
            index's or nowhere worse by distance (the flat index folds its
            candidate columns once; a shard does not), equal after the
            re-rank on 90% of the queries; timed against the flat index
            (CUDA-event medians); then the i8 index saved, reloaded on 4
            shards and re-striped onto 2, equal ids
  node      `python -m dawnsearch_tpu_torch` over a 270,000-page store
            (past the 262,144-row gate of the fused select) as wide as its
            encoder: on the seeded MiniLM weights once each with
            index_dtype i8, i4 and bf16, on i8 with index_kind "sharded"
            (mesh_shards = 0: one shard on the card; the store rebuilt into
            it, /api/insert through ShardedFusedIngestPath, an /api/profile
            capture during the queries whose trace must name K1's and K2's
            kernels), on i8 with DAWNSEARCH_LAYER_IMPL=ops
            DAWNSEARCH_POOL_IMPL=fused and with DAWNSEARCH_LAYER_IMPL=layer_i8;
            then on a seeded 12-layer BERT-base checkpoint written to a
            DAWNSEARCH_MODEL_DIR, on K1 and on K4, and on a seeded 12-layer
            all-mpnet-base-v2 checkpoint (its config.json, a 30527-line
            MPNet-layout vocab) on K1 and on K4, both with rel_bias, and on
            a seeded 6-layer all-distilroberta-v1 checkpoint (its
            config.json, vocab.json + merges.txt spelling the smoke texts'
            words) on K1 and on K4; then
            with DAWNSEARCH_COMPUTE_DTYPE=f32 on MiniLM K1 (with
            DAWNSEARCH_WARMUP=true), K4 and the per-op path and on the
            MPNet checkpoint's K1: 32 pages through /api/insert, 8 of them
            queried back through /api/search at rank 1 (the first query's
            server time printed beside the others'), the route's encoder
            kernel counters (every other encoder counter at 0) and the
            tier's select counter read from /api/metrics; every run's log
            must name the native tokenizer (WordPiece, or BPE for RoBERTa)
            in its "encoder ready" line
  swarm     P2P search and Common Crawl ingest, as users start them: `python
            -m dawnsearch_tpu_torch track` on 127.0.0.1, then two nodes on a
            seeded all-MiniLM-L6-v2 checkpoint (its config.json, 6 layers at
            full width, a word vocab; bf16, i8 index) with udp: node B on a
            copy of the 270,000-page store with index_cc over 2 gzip WARC
            files of 20,000 English HTML pages (write_warc; 1-4 KB each, a
            topic and an opening sentence of their own) and 2 extraction
            workers, node A on an empty data dir. B must ingest exactly the
            pages the port's iter_pages keeps (K1 at the ingest batches, up
            to B = 1024 and S = 512; pages/s and each ingest stage printed,
            its log naming the native tokenizer and the WARC, HTML and
            language readers); A and B each warm up with one query over
            their own HTTP (A's first remote query printed), then 24
            ingested pages are queried from A and each must come back at
            rank 1 from B, B's K2 counter rising with them and both nodes'
            K1 counter; every process stops on SIGTERM with exit 0. Then 64
            of B's stored embeddings against the same encoder on the plain
            path (K1 swapped for bert_layer_plain on the card) and the
            `sidecar` CLI's embeddings of one file against B's, each at min
            cosine 0.999
  crew      two processes on cuda:0 over gloo, started as users start them:
            the leader `python -m dawnsearch_tpu_torch --web` (DawnNode) and
            a follower `python -m dawnsearch_tpu_torch` with
            dist_process_id 1, index_kind "sharded" (one shard each),
            index_rerank "device", over a 524,288-page store rebuilt through
            the crew (coalesced adds; 262,144 rows a shard, so K2 runs in
            both processes); 32 pages in through /api/insert (K1 on the
            leader), 25 of them queried at rank 1, a save through the
            gather; both stop with exit 0 on the leader's SIGTERM; the
            snapshot then loads in this process on 2 shards and re-striped
            onto 4 with equal ids, every inserted page first. Prints the
            rebuild's rows/s and the median query time (the sharded node
            run's beside it)

The last two lines of a full run are a JSON line of per-kernel results
and {"ok": true, "device": {...}}. Times are CUDA-event medians of 10
runs after 3 warm-ups; the per-op kernels K5-K8, their plain twins and
library calls, which take tens of microseconds, are timed as CUDA-graph
replays of 10 calls (graph_ms), so the host's launch work is not in
their times. Each kernel's bound_ms is the larger of its
operations over the H100's dense peak for their type and its bytes (each
input read once, each output written once) over 3.35 TB/s; f32 work is
bound at f32 accuracy, as three TF32 products per multiply-add (3xTF32,
495 TFLOP/s of TF32), with the CUDA cores' FMA bound beside it
(ffma_bound_ms). A kernel's launches are counted over the runs of the
main path that a user drives: the node runs, the ops phase's encoders,
the swarm's two nodes and the crew's two processes, each started from
zero. --node-runs picks the
node phase's runs (a run
with a subset prints no last line).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import socket
import sqlite3
import string
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "k1", "k4", "k2", "k3", "k2bf16", "attn", "ffn",
          "pool", "recall", "recall_i4", "i4_scale", "profile", "ops", "sharded",
          "node", "swarm", "crew")
KERNEL_PHASES = {"build", "k1", "k4", "k2", "k3", "k2bf16", "attn", "ffn",
                 "pool"}
# layer widths (H, nh, I): all-MiniLM-L6-v2, BERT-base, BERT-large
MINILM_W, BASE_W, LARGE_W = (384, 12, 1536), (768, 12, 3072), (1024, 16, 4096)
# (width, B, S); the first is the entry's headline shape
K1_SHAPES = ((MINILM_W, 64, 128), (MINILM_W, 8, 512), (MINILM_W, 64, 16),
             (BASE_W, 64, 128), (LARGE_W, 8, 512))
K4_SHAPES = ((MINILM_W, 64, 128), (BASE_W, 64, 128), (LARGE_W, 8, 512),
             (MINILM_W, 1, 128), (BASE_W, 1, 128))
# the f32 instances (compute_dtype = "f32"), each entry at its route's
# serving shapes: K1 at MiniLM and BERT-base (64, 128), K4 at the same two
# and at one BERT-base query (B = 1)
K1_F32_SHAPES = (K1_SHAPES[0], K1_SHAPES[3])
K4_F32_SHAPES = (*K4_SHAPES[:2], K4_SHAPES[4])
# K1 and K4 with MPNet's relative-position bias (rel_bias), at
# all-mpnet-base-v2's width: (B, S), the first the entry's headline shape
REL_SHAPES = ((64, 128), (8, 512))
# bert-base-uncased's config.json (HF hub), the node runs' BERT-base
# checkpoint; the weights are seeded, 12 layers at full width
BERT_BASE_CONFIG = {
    "architectures": ["BertForMaskedLM"], "attention_probs_dropout_prob": 0.1,
    "gradient_checkpointing": False, "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1, "hidden_size": 768, "initializer_range": 0.02,
    "intermediate_size": 3072, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512, "model_type": "bert",
    "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 0,
    "position_embedding_type": "absolute", "transformers_version": "4.6.0.dev0",
    "type_vocab_size": 2, "use_cache": True, "vocab_size": 30522}
# sentence-transformers/all-MiniLM-L6-v2's config.json (HF hub), phase
# swarm's checkpoint; the weights are seeded, its 6 layers at full width
MINILM_CONFIG = {
    "architectures": ["BertModel"], "attention_probs_dropout_prob": 0.1,
    "gradient_checkpointing": False, "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1, "hidden_size": 384, "initializer_range": 0.02,
    "intermediate_size": 1536, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512, "model_type": "bert",
    "num_attention_heads": 12, "num_hidden_layers": 6, "pad_token_id": 0,
    "position_embedding_type": "absolute", "transformers_version": "4.8.2",
    "type_vocab_size": 2, "use_cache": True, "vocab_size": 30522}
# sentence-transformers/all-mpnet-base-v2's config.json (HF hub), the node
# runs' MPNet checkpoint; the weights are seeded, 12 layers at full width
MPNET_CONFIG = {
    "architectures": ["MPNetForMaskedLM"], "attention_probs_dropout_prob": 0.1,
    "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu",
    "hidden_dropout_prob": 0.1, "hidden_size": 768, "initializer_range": 0.02,
    "intermediate_size": 3072, "layer_norm_eps": 1e-05,
    "max_position_embeddings": 514, "model_type": "mpnet",
    "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 1,
    "relative_attention_num_buckets": 32, "vocab_size": 30527}
# sentence-transformers/all-distilroberta-v1's config.json (HF hub), the
# node runs' RoBERTa checkpoint; the weights are seeded, its 6 layers at
# full width
ROBERTA_CONFIG = {
    "architectures": ["RobertaModel"], "attention_probs_dropout_prob": 0.1,
    "bos_token_id": 0, "eos_token_id": 2, "gradient_checkpointing": False,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1, "hidden_size": 768,
    "initializer_range": 0.02, "intermediate_size": 3072,
    "layer_norm_eps": 1e-05, "max_position_embeddings": 514,
    "model_type": "roberta", "num_attention_heads": 12,
    "num_hidden_layers": 6, "pad_token_id": 1,
    "position_embedding_type": "absolute", "type_vocab_size": 1,
    "vocab_size": 50265}
MPNET_EPS = MPNET_CONFIG["layer_norm_eps"]
REL_BUCKETS = MPNET_CONFIG["relative_attention_num_buckets"]
# (H, nh, B, S); the first of each is the entry's headline shape: K5's
# is the node's per-op path, K6's the TinyBERT-width fallback
K5_SHAPES = ((384, 12, 64, 128), (384, 12, 8, 512), (384, 12, 64, 16),
             (768, 12, 64, 128))
K6_SHAPES = ((312, 12, 64, 128), (312, 12, 8, 512), *K5_SHAPES)
K5_F32_SHAPES, K6_F32_SHAPES = K5_SHAPES[:2], K6_SHAPES[:2]
# (rows, H, I): a B=64, S=128 batch at three widths, and one B=1 query at
# MiniLM width and at BERT-base width (a query on an MPNet per-op node)
FFN_SHAPES = ((64 * 128, 384, 1536), (64 * 128, 768, 3072),
              (64 * 128, 312, 1200), (128, 384, 1536), (128, 768, 3072))
FFN_F32_SHAPES = (*FFN_SHAPES[:2], *FFN_SHAPES[3:])
# K8 alone (B, S, H): a B=64 batch (the entry's headline), the node's
# query buckets, its ingest buckets of 128 and 256 (one CTA a sequence),
# long sequences at MiniLM's width, BERT-large's and 2048
POOL_SHAPES = ((64, 128, 384), (1, 128, 384), (8, 128, 384),
               (128, 128, 384), (256, 128, 384), (8, 512, 384),
               (8, 512, 1024), (8, 512, 2048))
POOL_STAGE_BATCHES = (1, 8, 64)  # encode_batch's pool stage, S = 128
TINYBERT = dict(hidden_size=312, num_heads=12, intermediate_size=1200,
                num_layers=4)
ENCODE_BATCHES, ENCODE_ROUNDS = (1, 8, 64), 6
K2_ROWS, K2_BATCH = 1 << 20, 1024
I4_RECALL_ROWS = 1 << 21
I4_SCALE_ROWS, I4_SCALE_ADD = 1 << 26, 1 << 20
NODE_PAGES = 270_000
# the node's i8 index at NODE_PAGES rows: FlatIndex's capacity doubles
# from 16,384 (index/flat.py), so 524,288 rows, 15 of 32 tiles past count
NODE_CAPACITY = 1 << 19
SMALL_BATCHES = (1, 8, 32)  # a searcher's batch buckets up to 32
NODE_TIERS = ("i8", "i4", "bf16")
PROFILE_BATCHES, PROFILE_K = (1, 8, 64), 50
COS_MIN = 0.999          # bf16 bound of the reference (test_pallas_kernels.py)
# K5-K7 vs their plain twins: the same bf16 rounding points, f32 sums in
# another order; K8 sums in f32 in either dtype
KERNEL_COS_MIN, POOL_ERR_MAX = 0.9999, 1e-5
# the f32 instances vs their twins run at f32 with TF32 off: f32 sums in
# another order. K1: max |d| and per-token cosine; K4: per-token cosine at
# its f32 CPU bound (tests/test_torch_layer_i8.py: one ulp can flip a
# re-quantized code); K5-K7: max |d| relative to the output's scale and
# per-row cosine
F32_ERR_MAX, F32_COS_MIN, K4_F32_COS_MIN = 1e-4, 0.99999, 0.99995
F32_REL_ERR_MAX = 1e-5
RAW_RECALL_MIN, RERANK_RECALL_MIN = 0.95, 0.99
# bf16-query select variants vs their plain twin: f32 sums of the same
# bf16 products in another order differ by a few ulps of the dot, which
# can move a truncated key by one step (128 ulps: 1.5e-5 in [1, 2),
# 3.1e-5 in [2, 4)). Bound: two key steps on the values, the window ids
# equal on at least 99% of (query, window) pairs, and the top-10 after
# the fold to k + 30 and an f32 re-rank equal for every query.
BF16_VAL_TOL, BF16_ID_SHARE = 3.1e-5, 0.99
# H100 SXM dense peaks (NVIDIA data sheet, 700 W) and HBM3 bandwidth. "f32"
# is the CUDA cores' FMA rate, "tf32" the tensor cores'. f32 work at f32
# accuracy is bound as "tf32x3": three TF32 products for each multiply-add
# (3xTF32, which K1's GEMM and the f32 attention run), 165 TFLOP/s; the
# FFMA bound rides beside it as ffma_bound_ms.
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
# each kernel entry's launch counter in /api/metrics
COUNTER = {"bert_layer": "kernel_bert_layer",
           "bert_layer_i8": "kernel_bert_layer_i8",
           "bert_layer_rel": "kernel_bert_layer_rel",
           "bert_layer_i8_rel": "kernel_bert_layer_i8_rel",
           "select_i8": "kernel_select",
           "select_i8_qbf16": "kernel_select_i8_qbf16",
           "select_bf16": "kernel_select_bf16",
           "select_i4": "kernel_select_i4",
           "select_i4_qbf16": "kernel_select_i4_qbf16",
           "attention_packed": "kernel_attention_packed",
           "attention": "kernel_attention", "ffn": "kernel_ffn",
           "mean_pool": "kernel_mean_pool",
           "bert_layer_f32": "kernel_bert_layer_f32",
           "bert_layer_rel_f32": "kernel_bert_layer_rel_f32",
           "bert_layer_i8_f32": "kernel_bert_layer_i8_f32",
           "attention_packed_f32": "kernel_attention_packed_f32",
           "attention_f32": "kernel_attention_f32",
           "ffn_f32": "kernel_ffn_f32"}
# every encoder kernel's counter (ops/layer.py, ops/attention.py, ops/ffn.py)
ENCODER_COUNTERS = (
    *(f"kernel_bert_layer{k}{r}{f}" for k in ("", "_i8") for r in ("", "_rel")
      for f in ("", "_f32")),
    "kernel_attention_packed", "kernel_attention",
    "kernel_attention_packed_f32", "kernel_attention_f32", "kernel_ffn",
    "kernel_ffn_f32", "kernel_mean_pool")
# select launch counters (ops/scan_select.VARIANTS) by node tier
NODE_SELECT = {"i8": "kernel_select", "i4": "kernel_select_i4",
               "bf16": "kernel_select_bf16"}
PER_OP_ENV = {"DAWNSEARCH_LAYER_IMPL": "ops", "DAWNSEARCH_POOL_IMPL": "fused"}
K4_ENV = {"DAWNSEARCH_LAYER_IMPL": "layer_i8"}
F32_ENV = {"DAWNSEARCH_COMPUTE_DTYPE": "f32"}
WARMUP_ENV = {"DAWNSEARCH_WARMUP": "true"}
PER_OP = ("kernel_attention_packed", "kernel_ffn", "kernel_mean_pool")
# one shard on one card (mesh_shards = 0): ShardedFusedIngestPath, the
# sharded search, and an /api/profile capture
SHARDED_ENV = {"DAWNSEARCH_INDEX_KIND": "sharded", "DAWNSEARCH_MESH_SHARDS": "0"}
# (label, tier, extra environment, encoder counters that must rise (every
# other encoder counter must stay 0), model: None for the node's seeded
# MiniLM weights, "base" / "mpnet" / "roberta" for the seeded BERT-base /
# all-mpnet-base-v2 / all-distilroberta-v1 checkpoint)
NODE_RUNS = (
    *((t, t, {}, ("kernel_bert_layer",), None) for t in NODE_TIERS),
    ("sharded", "i8", SHARDED_ENV, ("kernel_bert_layer",), None),
    ("i8-ops", "i8", PER_OP_ENV, PER_OP, None),
    ("i8-k4", "i8", K4_ENV, ("kernel_bert_layer_i8",), None),
    ("base", "i8", {}, ("kernel_bert_layer",), "base"),
    ("base-k4", "i8", K4_ENV, ("kernel_bert_layer_i8",), "base"),
    ("mpnet", "i8", {}, ("kernel_bert_layer_rel",), "mpnet"),
    ("mpnet-k4", "i8", K4_ENV, ("kernel_bert_layer_i8_rel",), "mpnet"),
    ("roberta", "i8", {}, ("kernel_bert_layer",), "roberta"),
    ("roberta-k4", "i8", K4_ENV, ("kernel_bert_layer_i8",), "roberta"),
    # compute_dtype = "f32": the f32 instance of each route's kernels; the
    # first also warms the encoder's bucket grid up before it serves
    ("f32", "i8", {**F32_ENV, **WARMUP_ENV}, ("kernel_bert_layer_f32",), None),
    ("f32-k4", "i8", {**F32_ENV, **K4_ENV}, ("kernel_bert_layer_i8_f32",),
     None),
    ("f32-ops", "i8", {**F32_ENV, **PER_OP_ENV},
     ("kernel_attention_packed_f32", "kernel_ffn_f32", "kernel_mean_pool"),
     None),
    ("mpnet-f32", "i8", F32_ENV, ("kernel_bert_layer_rel_f32",), "mpnet"))

TEXTS = [
    "the lighthouse keeper climbed the spiral stairs every night to trim the wick and watch the storm roll over the black rocks",
    "quantum error correction spreads one logical qubit across many physical qubits so that single faults can be detected and undone",
    "knead the sourdough for ten minutes then let it rise overnight in a cool kitchen before baking it in a hot cast iron pot",
    "the mountain railway climbs through seven tunnels and over a stone viaduct before it reaches the pass at two thousand metres",
    "anglerfish in the midnight zone lure their prey with a glowing filament that hangs in front of a mouth full of needle teeth",
    "the treaty ended the war between the two kingdoms and fixed the border along the river for the next three hundred years",
    "a binary heap keeps its smallest key at the root and restores the heap property by sifting an element up or down the tree",
    "monarch butterflies migrate thousands of kilometres each autumn to the same fir forests in the mountains of central mexico",
    "the jazz quartet improvised over a slow blues in f while the drummer brushed the snare and the bassist walked the changes",
    "to replace a bicycle chain remove the old one with a chain tool count the links and join the new chain with a quick link",
    "volcanic eruptions inject sulfur dioxide into the stratosphere where it forms droplets that reflect sunlight and cool the planet",
    "the striker curled a free kick over the wall and into the top corner to win the cup final in the last minute of extra time",
    "medieval monks copied manuscripts by candlelight and decorated the first letter of each page with gold leaf and blue pigment",
    "a cold front brings a sharp drop in temperature gusty winds and a line of thunderstorms followed by clear dry air",
    "the compiler lowers each loop to an intermediate form unrolls the body and schedules the instructions to hide memory latency",
    "honey bees communicate the direction and distance of flowers to their hive mates with a waggle dance on the comb",
    "the orchestra tuned to the oboe before the conductor raised the baton for the opening chords of the symphony",
    "tidal pools hold anemones starfish and hermit crabs that survive the hours when the sea retreats from the rocks",
    "inflation erodes the purchasing power of savings so central banks raise interest rates to cool demand in the economy",
    "the knight moves in an l shape and is the only chess piece that can jump over other pieces on the board",
    "glaciers carve u shaped valleys and leave behind moraines of boulders gravel and sand when the ice finally melts away",
    "the recipe for green curry starts with frying the paste in coconut cream until the oil separates and the kitchen smells of lime leaf",
    "a suspension bridge hangs its deck from vertical cables attached to two main cables draped over tall towers",
    "the astronaut floated through the hatch of the space station and checked the air scrubbers before the crew woke up",
    "wolves hunt in packs that follow elk herds across the snow for days and take the weak or the old first",
    "the potter centred the clay on the wheel opened it with her thumbs and pulled the walls up into a tall thin vase",
    "public key cryptography lets two strangers agree on a shared secret over an open channel that anyone can read",
    "coral reefs bleach when warm water drives out the algae that live in their tissue and give them food and colour",
    "the desert caravan rested at the oasis where date palms shaded a spring and the camels drank for an hour",
    "a sonnet has fourteen lines of iambic pentameter and often turns its argument at the ninth line",
    "the marathon runner paced the first half carefully drank at every station and finished with a negative split",
    "photosynthesis in the chloroplast uses light to split water and store the energy in sugar made from carbon dioxide",
]
QUERIED = (0, 3, 7, 12, 18, 22, 27, 31)

# phase sharded: a 4-shard index on one card, one shard a K2 gate's worth
SHARDED_ROWS, SHARDED_SHARDS, SHARDED_BATCHES = 1 << 20, 4, (1, 8, 32)
SHARDED_EQUAL_SHARE = 0.9  # of the 41 queries, after the f16 re-rank
# phase crew: two processes on one card, one shard each at the K2 gate
CREW_ROWS, CREW_QUERIES = 1 << 19, 25

# phase swarm: a Common Crawl-like corpus ingested by node B and searched
# from node A through B over UDP
SWARM_PAGES = 20_000   # English HTML pages over SWARM_FILES gzip WARC files
SWARM_FILES = 2
SWARM_QUERIES = 24     # ingested pages queried from A, each at rank 1 from B
SWARM_CHECKED = 64     # ingested pages re-encoded on the plain path
STOPWORDS = ("the", "of", "and", "a", "to", "in", "is", "was", "it", "for",
             "on", "that", "with", "as", "by", "at", "from", "this", "are")
CONTENT = sorted({w for t in TEXTS for w in t.split()} - set(STOPWORDS))


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one fn(): `calls` calls captured in one CUDA graph
    (after warm-up calls on a side stream), the median CUDA-event time of
    `reps` replays over `calls`. The host's per-call work (argument
    checks, allocation, the launch itself) is not in it, which matters
    for kernels of tens of microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps=reps, warmup=1) / calls


# -- phases ---------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    say(f"phase device: {name}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from dawnsearch_tpu_torch.ops import _cuda
    from dawnsearch_tpu_torch.utils import nativelib
    t0 = time.perf_counter()
    path = nativelib.build()  # raises with g++'s output if it fails
    if nativelib.get() is None:
        raise RuntimeError(f"native library did not load: "
                           f"{nativelib.build_error()}")
    built = nativelib.BUILD_SECONDS.get("native")
    say(f"phase build: {os.path.relpath(path, HERE)} ready in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({'g++ ' + format(built, '.1f') + ' s' if built else 'cached'})")
    # the WARC parser (zlib) builds alone: without it ingest takes the
    # Python reader, with the same records
    t0 = time.perf_counter()
    if nativelib.get_warc() is None:
        say(f"phase build: the WARC parser did not build, ingest takes the "
            f"Python reader: {nativelib.build_error('warc')}")
    else:
        built = nativelib.BUILD_SECONDS.get("warc")
        path = nativelib.library_path("warc")
        say(f"phase build: {os.path.relpath(path, HERE)} ready in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({'g++ ' + format(built, '.1f') + ' s' if built else 'cached'})")
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.lib()
    built = _cuda.BUILD_SECONDS
    say(f"phase build: {os.path.relpath(path, HERE)} ready in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({'nvcc ' + format(built, '.1f') + ' s' if built else 'cached'})")
    # ptxas -v: "Compiling entry function '<mangled>' ..." then "Used N
    # registers, ..." for each kernel
    entry = None
    for line in _cuda.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line and entry:
            say(f"phase build: ptxas {entry}: {line.split(':', 1)[-1].strip()}")
            entry = None


def bound(ops: float, kind: str, nbytes: float) -> dict:
    """The least time the card could take: the larger of ops over the
    dense peak for their type (kind "tf32x3": 3·ops over the TF32 peak,
    and the FFMA bound beside it) and bytes over the HBM bandwidth."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    extra = {}
    if kind == "tf32x3":
        t_ops = 3 * ops / PEAK_OPS["tf32"] * 1e3
        extra["ffma_bound_ms"] = max(ops / PEAK_OPS["f32"] * 1e3, t_bytes)
    else:
        t_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            **extra}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _layer_weights(rng: np.random.Generator, H: int, I: int, dev,
                   dtype=torch.bfloat16) -> list:
    """Seeded weights of one layer at width H, FFN I: matrices in `dtype`
    and non-trivial f32 biases and LayerNorm parameters."""
    def mat(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.05
                                ).to(dev, dtype)

    def vec(n, base=0.0):
        return torch.from_numpy(base + rng.standard_normal(n, np.float32) * 0.1
                                ).to(dev)
    return [mat(H, 3 * H), vec(3 * H), mat(H, H), vec(H), vec(H, 1.0), vec(H),
            mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]


def library_layer(weights: list, H: int, I: int, nh: int, eps: float = 1e-12,
                  dtype=torch.bfloat16):
    """torch's TransformerEncoderLayer (post-LN, erf GELU) in `dtype` with
    the K1 weights: the one PyTorch call that computes the same layer. It
    is K1's library yardstick only; the port never calls it."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = weights
    lay = torch.nn.TransformerEncoderLayer(
        H, nh, I, dropout=0.0, activation="gelu", layer_norm_eps=eps,
        batch_first=True, device=wqkv.device, dtype=dtype).eval()
    with torch.no_grad():
        for dst, src in ((lay.self_attn.in_proj_weight, wqkv.T),
                         (lay.self_attn.in_proj_bias, bqkv),
                         (lay.self_attn.out_proj.weight, wo.T),
                         (lay.self_attn.out_proj.bias, bo),
                         (lay.norm1.weight, g1), (lay.norm1.bias, be1),
                         (lay.linear1.weight, w1.T), (lay.linear1.bias, b1),
                         (lay.linear2.weight, w2.T), (lay.linear2.bias, b2),
                         (lay.norm2.weight, g2), (lay.norm2.bias, be2)):
            dst.copy_(src)
    return lay


def layer_flops(B: int, S: int, H: int, I: int) -> tuple[int, int]:
    """(projection, attention) operations of one layer: 2·M·(4H² + 2HI)
    and 4·B·S²·H."""
    return 2 * B * S * (4 * H * H + 2 * H * I), 4 * B * S * S * H


def k1_bound(B: int, S: int, H: int, I: int, x, weights, rel=None) -> dict:
    """Projections and attention at the peak of x's dtype (bf16, or f32
    work as tf32x3); bytes: x, y, the weights (the (in, out) matrices),
    the (B, S) key bias and the (nh, S, S) rel_bias if any (its B·nh·S²
    adds are left out: < 0.1% of the operations)."""
    return bound(sum(layer_flops(B, S, H, I)), _peak(x.dtype),
                 2 * nbytes(x) + nbytes(*weights, rel) + B * S * 4)


def _tag(dtype) -> str:
    """The shape tag of a compute dtype."""
    return "f32" if dtype == torch.float32 else "bf16"


def _peak(dtype) -> str:
    """The bound kind of work in a compute dtype: bf16, or f32 work at f32
    accuracy (tf32x3)."""
    return "tf32x3" if dtype == torch.float32 else "bf16"


def _k1_form(weights: list) -> list:
    """K1's (and K7's) weights as its kernel takes them: at f32 each (in,
    out) matrix as its (W_hi, W_lo) pair (ops/layer.py::tf32_pair), as the
    model holds them on the card; bf16 and the plain twin take them as
    they are."""
    from dawnsearch_tpu_torch.ops.layer import tf32_pair
    return [tf32_pair(t) if t.ndim == 2 and t.dtype == torch.float32 else t
            for t in weights]


def _f32_twins() -> None:
    """The f32 entries hold each kernel to its twin run in f32: the twin's
    products must be true f32 products, not TF32."""
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 is on: the f32 twins would not be f32")


def _token_check(got, want, mask) -> tuple[float, float, bool]:
    """max |got - want| and min per-token cosine over unmasked tokens, and
    whether the output is finite."""
    got, want = got.float(), want.float()
    err = float((got - want)[mask].abs().max())
    cos = torch.nn.functional.cosine_similarity(got[mask], want[mask], dim=-1)
    return err, float(cos.min()), bool(torch.isfinite(got).all())


def _layer_ok(err: float, cos: float, pooled: float, finite: bool,
              dtype) -> bool:
    """K1 against its twin: the reference's bf16 cosine bound on tokens
    and pooled rows, or max |d| <= 1e-4 and token cosine >= 0.99999 in
    f32."""
    if dtype == torch.float32:
        return finite and err <= F32_ERR_MAX and cos >= F32_COS_MIN
    return finite and cos > COS_MIN and pooled > COS_MIN


def phase_k1(results: list) -> None:
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    made: dict = {}
    results.append(k1_entry(rng, dev, K1_SHAPES, torch.bfloat16, made))
    results[-1]["gemms"] = k1_gemms(rng, dev, made)
    phase_k1_rel(results, rng, made[BASE_W[0], BASE_W[2], torch.bfloat16][0])
    _f32_twins()
    results.append(k1_entry(rng, dev, K1_F32_SHAPES, torch.float32, made))
    results[-1]["gemms"] = k1_gemms(rng, dev, made, torch.float32)
    phase_k1_rel(results, rng, made[BASE_W[0], BASE_W[2], torch.float32][0])


def k1_entry(rng: np.random.Generator, dev, k1_shapes, dtype,
             made: dict) -> dict:
    """K1 at `dtype` vs bert_layer_plain at each shape, ragged masks, timed
    beside torch's TransformerEncoderLayer on the same weights (fast
    path); weights are made once per width and dtype into `made`."""
    from dawnsearch_tpu_torch.ops import layer
    shapes = []
    for (H, nh, I), B, S in k1_shapes:
        if (H, I, dtype) not in made:
            weights = _layer_weights(rng, H, I, dev, dtype)
            made[H, I, dtype] = weights, library_layer(weights, H, I, nh,
                                                       dtype=dtype)
        weights, lib = made[H, I, dtype]
        kw = _k1_form(weights)
        x = torch.from_numpy(rng.standard_normal((B, S, H), np.float32)
                             ).to(dev, dtype)
        mask, bias = _ragged(rng, B, S, dev)
        got = layer.fused_bert_layer(x, bias, *kw, nh=nh).float()
        want = layer.bert_layer_plain(x, bias, *weights, nh=nh).float()
        torch.cuda.synchronize()
        err, cos, finite = _token_check(got, want, mask)
        m = mask[..., None].float()
        pooled = float(torch.nn.functional.cosine_similarity(
            (got * m).sum(1), (want * m).sum(1), dim=-1).min())
        ok = _layer_ok(err, cos, pooled, finite, dtype)
        with torch.inference_mode():
            lib_out = lib(x, src_key_padding_mask=~mask).float()
            lib_cos = float(torch.nn.functional.cosine_similarity(
                lib_out[mask], want[mask], dim=-1).min())
            library_ms = cuda_ms(lambda: lib(x, src_key_padding_mask=~mask))
        ms = cuda_ms(lambda: layer.fused_bert_layer(x, bias, *kw, nh=nh))
        plain_ms = cuda_ms(lambda: layer.bert_layer_plain(x, bias, *weights,
                                                          nh=nh))
        bd = k1_bound(B, S, H, I, x, weights)
        shape = f"B={B} S={S} H={H} nh={nh} I={I} {_tag(dtype)}"
        say(f"phase k1 {shape}: max|d|={err:.3e} min token cos={cos:.7f} "
            f"min pooled cos={pooled:.7f} kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms library {library_ms:.3f} ms (min token "
            f"cos vs plain {lib_cos:.4f}) bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape}")
        if not lib_cos >= 0.99:  # NaN fails too
            raise AssertionError(f"the library layer computes another "
                                 f"function (token cos {lib_cos:.4f})")
        shapes.append({"shape": shape, "max_abs_err": err,
                       "min_token_cos": cos, "ms": ms, "plain_ms": plain_ms,
                       **bd, "library_ms": library_ms})
    # the entry's numbers are the first (serving-batch) shape's; the
    # others ride along
    return {"name": "bert_layer" + ("_f32" if dtype == torch.float32 else ""),
            "route": "cuda",
            "source": "dawnsearch_tpu_torch/csrc/layer.cu",
            "replaces": "dawnsearch_tpu/ops/layer.py:275"
                        + (" (f32)" if dtype == torch.float32 else ""),
            **shapes[0], "other_shapes": shapes[1:]}


def k1_gemms(rng: np.random.Generator, dev, made: dict, dtype=torch.bfloat16
             ) -> list:
    """Each of K1's four projections alone (ops/layer.py::_gemm, the TMA +
    wgmma GEMM) on the entry's weights of `dtype`. bf16: at every
    K1_SHAPES shape and at M = 128 (one B=1 query) of each width, against
    the f32 product of the same bf16 operands with its epilogue in f32,
    rounded once: per-row cosine >= KERNEL_COS_MIN (the same rounding
    point, f32 sums in another order). f32 (3xTF32, W as its tf32_pair):
    at MiniLM and BERT-base widths at M = 8192 and 128, against the f64
    product with its epilogue in f64: max |d| <= F32_REL_ERR_MAX of the
    output's scale and per-row cosine >= F32_COS_MIN, the error of
    torch.addmm in f32 beside it. Device time (graph_ms) beside
    torch.addmm of the same product and bias in the same dtype (TF32 off),
    the yardstick (the port never calls it; it has no GELU or LayerNorm),
    and the bound of the projection."""
    from dawnsearch_tpu_torch.ops import layer
    from dawnsearch_tpu_torch.ops.ffn import erf_poly
    from dawnsearch_tpu_torch.ops.vector import layer_norm
    f32 = dtype == torch.float32
    if f32:
        shapes = [(w, M) for M in (64 * 128, 128) for w in (MINILM_W, BASE_W)]
    else:
        shapes = [(w, B * S) for w, B, S in K1_SHAPES]
        shapes += [(w, 128) for w in (MINILM_W, BASE_W, LARGE_W)]
    wide = torch.float64 if f32 else torch.float32
    rows = []
    for (H, nh, I), M in shapes:
        (wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2) = \
            made[H, I, dtype][0]

        def act(n):
            return torch.from_numpy(rng.standard_normal((M, n), np.float32)
                                    ).to(dev, dtype)
        x, ctx, x1, h = act(H), act(H), act(H), act(I)
        for name, a, w, b, epi, resid, ln_s, ln_b in (
                ("qkv + bias", x, wqkv, bqkv, 0, None, None, None),
                ("attention out + LN", ctx, wo, bo, 2, x, g1, be1),
                ("FFN in + GELU", x1, w1, b1, 1, None, None, None),
                ("FFN out + LN", h, w2, b2, 2, x1, g2, be2)):
            kw = layer.tf32_pair(w) if f32 else w

            def gemm():
                return layer._gemm(a, kw, b, epi, resid, ln_s, ln_b)
            got = gemm()
            want = a.to(wide) @ w.to(wide) + b.to(wide)
            if epi == 1:
                want = 0.5 * want * (1.0 + erf_poly(want * 2.0 ** -0.5))
            elif epi == 2:
                want = layer_norm(want + resid.to(wide), ln_s.to(wide),
                                  ln_b.to(wide), 1e-12)
            torch.cuda.synchronize()
            err = float((got.to(wide) - want).abs().max())
            cos = float(_row_cos(got, want, w.shape[1]).min())
            ms = graph_ms(gemm)
            b_dt = b.to(dtype)
            addmm_ms = graph_ms(lambda: torch.addmm(b_dt, a, w))
            K, N = w.shape
            flops = 2 * M * N * K
            bd = bound(flops, _peak(dtype),
                       nbytes(a, w, b, resid, ln_s, ln_b)
                       + M * N * a.element_size())
            shape = f"{name} M={M} K={K} N={N} {_tag(dtype)}"
            row = {"shape": shape, "max_abs_err": err, "min_row_cos": cos,
                   "ms": ms, **bd, "library_ms": addmm_ms}
            scale = float(want.abs().max())
            if f32:
                ok = err <= F32_REL_ERR_MAX * scale and cos >= F32_COS_MIN
                # addmm has no epilogue: its error on the bias GEMM only
                row["library_max_abs_err"] = (
                    float((torch.addmm(b, a, w).to(wide) - want).abs().max())
                    if epi == 0 else None)
            else:
                ok = cos >= KERNEL_COS_MIN
            say(f"phase k1 gemm {shape}: max|d|={err:.3e} (scale "
                f"{scale:.3f}) min row cos={cos:.7f} kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.0f} TFLOP/s) addmm {addmm_ms:.4f} ms "
                f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            if not (ok and np.isfinite(err)):
                raise AssertionError(f"K1's GEMM disagrees with the "
                                     f"{'f64' if f32 else 'f32'} product at "
                                     f"{shape}")
            rows.append(row)
    return rows


def _rel_bias(rng: np.random.Generator, S: int, nh: int, dev):
    """MPNet's (nh, S, S) f32 score bias, gathered by the port's
    position_bias from a seeded (32, nh) table."""
    from dawnsearch_tpu_torch.models.mpnet import position_bias
    table = torch.from_numpy(rng.standard_normal((REL_BUCKETS, nh), np.float32)
                             * 0.5).to(dev)
    return position_bias(table, S, nh, REL_BUCKETS)


def phase_k1_rel(results: list, rng: np.random.Generator,
                 weights: list) -> None:
    """K1 with MPNet's rel_bias at all-mpnet-base-v2's width, on the
    BERT-base entry's weights (their dtype is the entry's), vs
    bert_layer_plain with the same operand (bf16: per-token cosine >=
    KERNEL_COS_MIN; f32: K1's f32 bound), timed beside K1 without it. The
    library yardstick is the same TransformerEncoderLayer with rel_bias
    plus the key mask as one float (B·nh, S, S) src_mask, off torch's MHA
    fast path (which reads a float 3-D mask as a boolean one and returns
    NaN)."""
    from dawnsearch_tpu_torch.ops import layer
    H, nh, I = BASE_W
    dev, dtype = weights[0].device, weights[0].dtype
    lib = library_layer(weights, H, I, nh, eps=MPNET_EPS, dtype=dtype)
    kw = _k1_form(weights)
    shapes = []
    for B, S in REL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((B, S, H), np.float32)
                             ).to(dev, dtype)
        mask, bias = _ragged(rng, B, S, dev)
        rel = _rel_bias(rng, S, nh, dev)

        def k1(rel_bias=rel):
            return layer.fused_bert_layer(x, bias, *kw, nh=nh,
                                          eps=MPNET_EPS, rel_bias=rel_bias)
        got = k1().float()
        want = layer.bert_layer_plain(x, bias, *weights, nh=nh, eps=MPNET_EPS,
                                      rel_bias=rel).float()
        norel = k1(None).float()
        torch.cuda.synchronize()
        err, cos, finite = _token_check(got, want, mask)
        moved = _token_check(norel, want, mask)[1]
        src_mask = (rel[None] + bias[:, None, None, :]).to(dtype) \
            .reshape(B * nh, S, S)
        fastpath = torch.backends.mha.get_fastpath_enabled()
        torch.backends.mha.set_fastpath_enabled(False)
        try:
            with torch.inference_mode():
                lib_out = lib(x, src_mask=src_mask).float()
                lib_cos = float(torch.nn.functional.cosine_similarity(
                    lib_out[mask], want[mask], dim=-1).min())
                library_ms = cuda_ms(lambda: lib(x, src_mask=src_mask))
        finally:
            torch.backends.mha.set_fastpath_enabled(fastpath)
        ms = cuda_ms(k1)
        norel_ms = cuda_ms(lambda: k1(None))
        plain_ms = cuda_ms(lambda: layer.bert_layer_plain(
            x, bias, *weights, nh=nh, eps=MPNET_EPS, rel_bias=rel))
        bd = k1_bound(B, S, H, I, x, weights, rel)
        shape = f"B={B} S={S} H={H} nh={nh} I={I} {_tag(dtype)} rel_bias"
        say(f"phase k1 {shape}: max|d|={err:.3e} min token cos={cos:.7f} "
            f"(without rel {moved:.4f}) kernel {ms:.3f} ms, without rel "
            f"{norel_ms:.3f} ms, plain {plain_ms:.3f} ms library "
            f"{library_ms:.3f} ms (min token cos vs plain {lib_cos:.4f}) "
            f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        ok = (_layer_ok(err, cos, 1.0, finite, dtype)
              if dtype == torch.float32 else finite and cos >= KERNEL_COS_MIN)
        if not ok:
            raise AssertionError(f"K1 with rel_bias disagrees with its plain "
                                 f"version at {shape}")
        if not lib_cos >= 0.99:  # NaN fails too
            raise AssertionError(f"the library layer computes another "
                                 f"function (token cos {lib_cos:.4f})")
        shapes.append({"shape": shape, "max_abs_err": err,
                       "min_token_cos": cos, "min_token_cos_without_rel": moved,
                       "ms": ms, "norel_ms": norel_ms, "plain_ms": plain_ms,
                       **bd, "library_ms": library_ms})
    f32 = dtype == torch.float32
    results.append({"name": "bert_layer_rel" + ("_f32" if f32 else ""),
                    "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/attention.cu",
                    "replaces": "dawnsearch_tpu/ops/layer.py:275 (rel_bias"
                                + (", f32)" if f32 else ")"),
                    **shapes[0], "other_shapes": shapes[1:]})


def k4_bound(B: int, S: int, H: int, I: int, x, qweights: list,
             rel=None) -> dict:
    """The four projections at the int8 peak plus attention at the peak
    of x's dtype (bf16 or f32), or the bytes (x, y, i8 weights, scales,
    biases, key bias, the rel_bias if any) over the HBM bandwidth,
    whichever is larger."""
    proj, attn = layer_flops(B, S, H, I)
    t_ops = (proj / PEAK_OPS["int8"] + attn / PEAK_OPS[_tag(x.dtype)]) * 1e3
    t_bytes = (2 * nbytes(x) + nbytes(*qweights, rel) + B * S * 4) \
        / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_k4(results: list) -> None:
    """K4 against bert_layer_i8_plain on ragged masks at MiniLM, BERT-base
    and BERT-large widths and at one query (B = 1) of the first two in
    bf16, and at MiniLM, BERT-base and one BERT-base query in f32 (the f32
    instance), each timed beside K1 on the same f32 weights (K1's in the
    entry's dtype, i8 codes (N, K) and scales from i8_weight for K4), with
    its device time split by kernel (torch.profiler); its four s8 GEMMs
    alone; then a 12-layer BERT-base-width encode_batch on K1 and on K4 at
    B = 1 and 64, S = 128, as device time (CUDA-graph replays). No single
    PyTorch call computes a W8A8 layer, so the layer has no library time;
    each GEMM has torch._int_mm's."""
    rng = np.random.default_rng(14)
    dev = torch.device("cuda")
    results.append(k4_entry(rng, dev, K4_SHAPES, torch.bfloat16))
    results[-1]["gemms"] = k4_gemms(rng, dev)
    phase_k4_rel(results, rng, dev)
    _f32_twins()
    results.append(k4_entry(rng, dev, K4_F32_SHAPES, torch.float32))
    for family in ("bert", "mpnet"):
        encode_base(rng, dev, family)


# K4's CUDA launches, by the part of the layer each is (kernel names as
# the profiler reports them; csrc/layer_i8.cu's six launches)
K4_PARTS = (("quantize x, ctx", "quant_rows_kernel"),
            ("attention", "attention_seq_kernel"),
            ("qkv GEMM", "gemm_kernel<64, 0,|gemm_kernel<128, 0,"),
            ("attn-out GEMM + quantize x1", r"gemm_kernel<(64|128), 2, "
             r"signed char, (__nv_bfloat16|float), float>"),
            ("FFN-in GEMM + GELU + h absmax",
             "gemm_kernel<64, 1,|gemm_kernel<128, 1,"),
            ("FFN-out GEMM + quantize h", "gemm_kernel<64, 2,|"
             "gemm_kernel<128, 2,"))


def k4_split(fn, calls: int = 10) -> dict:
    """K4's device time a call, split by part (K4_PARTS, the first pattern
    that matches a kernel's name): torch.profiler's sums over `calls`
    calls. The two LayerNorm GEMMs are told apart by their residual and
    output types: the attention-out one writes f32 (x1); at f32 both do,
    and both count under the attention-out label."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        part = next((label for label, pattern in K4_PARTS
                     if re.search(pattern, e.key)), "other")
        split[part] = split.get(part, 0.0) \
            + e.self_device_time_total / calls / 1e3
    return split


def k4_entry(rng: np.random.Generator, dev, k4_shapes, dtype) -> dict:
    from dawnsearch_tpu_torch.ops import layer
    cos_min = K4_F32_COS_MIN if dtype == torch.float32 else KERNEL_COS_MIN
    shapes = []
    for (H, nh, I), B, S in k4_shapes:
        f32 = _layer_weights(rng, H, I, dev, dtype=torch.float32)
        k1w = _k1_form([t.to(dtype) if t.ndim == 2 else t for t in f32])
        # quantized on the CPU from the f32 matrices, as the model does at load
        k4w = [tuple(q.to(dev) for q in layer.i8_weight(t.cpu()))
               if t.ndim == 2 else t for t in f32]
        flat = [t for w in k4w for t in (w if isinstance(w, tuple) else (w,))]
        x = torch.from_numpy(rng.standard_normal((B, S, H), np.float32)
                             ).to(dev, dtype)
        mask, bias = _ragged(rng, B, S, dev)
        got = layer.fused_bert_layer_i8(x, bias, *k4w, nh=nh)
        want = layer.bert_layer_i8_plain(x, bias, *k4w, nh=nh)
        k1_out = layer.fused_bert_layer(x, bias, *k1w, nh=nh)
        torch.cuda.synchronize()
        err, cos, finite = _token_check(got, want, mask)
        k1_cos = _token_check(got, k1_out, mask)[1]
        ms = cuda_ms(lambda: layer.fused_bert_layer_i8(x, bias, *k4w, nh=nh))
        k1_ms = cuda_ms(lambda: layer.fused_bert_layer(x, bias, *k1w, nh=nh))
        plain_ms = cuda_ms(lambda: layer.bert_layer_i8_plain(x, bias, *k4w,
                                                             nh=nh))
        split = k4_split(lambda: layer.fused_bert_layer_i8(x, bias, *k4w,
                                                           nh=nh))
        bd = k4_bound(B, S, H, I, x, flat)
        shape = f"B={B} S={S} H={H} nh={nh} I={I} {_tag(dtype)} W8A8"
        say(f"phase k4 {shape}: max|d|={err:.3e} min token cos={cos:.7f} "
            f"(vs K1 {k1_cos:.6f}) kernel {ms:.3f} ms K1 {k1_ms:.3f} ms "
            f"(K4/K1 {ms / k1_ms:.3f}) plain {plain_ms:.3f} ms bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); device ms by part: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        if not (finite and cos >= cos_min):
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{shape} (cos bound {cos_min})")
        shapes.append({"shape": shape, "max_abs_err": err,
                       "min_token_cos": cos, "min_token_cos_vs_k1": k1_cos,
                       "ms": ms, "k1_ms": k1_ms, "plain_ms": plain_ms, **bd,
                       "library_ms": None, "device_ms_by_part": split})
        del f32, k1w, k4w, flat
    f32 = dtype == torch.float32
    return {"name": "bert_layer_i8" + ("_f32" if f32 else ""), "route": "cuda",
            "source": "dawnsearch_tpu_torch/csrc/layer_i8.cu",
            "replaces": "dawnsearch_tpu/ops/layer.py:318"
                        + (" (f32)" if f32 else ""),
            **shapes[0], "other_shapes": shapes[1:]}


def _int_mm(a, wq):
    """torch._int_mm of the (M, K) codes and the (N, K) weight codes: the
    s32 product, the yardstick of one s8 GEMM (the port never calls it)."""
    return torch._int_mm(a, wq.t())


def k4_gemms(rng: np.random.Generator, dev) -> list:
    """Each of K4's four s8 GEMMs alone (ops/layer.py::_gemm_i8, the TMA +
    wgmma GEMM with its epilogue and, for the LayerNorm ones, the
    FFN-out one's quantization of h in its prologue) in bf16, at M = 8192 of
    MiniLM and BERT-base, 4096 of BERT-large and 128 (one B=1 query) of
    MiniLM and BERT-base, against the plain twin's arithmetic on the same
    operands (_mm_codes, the GELU, layer_norm, quant_rows): per-row cosine
    >= KERNEL_COS_MIN; the attention-out GEMM's x1 codes and factors,
    made in its epilogue, bit-equal to quant_rows of the x1 it wrote, and
    the GELU GEMM's partial absmax bit-equal to that of the h it wrote.
    The FFN-out GEMM's codes of h (made in its prologue) enter only its
    products. Device time
    (graph_ms) beside torch._int_mm of the same product and the bound of
    the projection."""
    from dawnsearch_tpu_torch.ops import layer
    from dawnsearch_tpu_torch.ops.ffn import erf_poly
    from dawnsearch_tpu_torch.ops.vector import layer_norm
    dt = torch.bfloat16
    shapes = [(MINILM_W, 8192), (BASE_W, 8192), (LARGE_W, 4096),
              (MINILM_W, 128), (BASE_W, 128)]
    rows = []
    for (H, nh, I), M in shapes:
        f32 = _layer_weights(rng, H, I, dev, dtype=torch.float32)
        wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = [
            tuple(q.to(dev) for q in layer.i8_weight(t.cpu()))
            if t.ndim == 2 else t for t in f32]

        def act(n, dtype=torch.float32):
            return torch.from_numpy(rng.standard_normal((M, n), np.float32)
                                    ).to(dev, dtype)
        x, ctx, x1, h = act(H, dt), act(H), act(H), act(I)
        xq, xrf = layer.quant_rows(x.float())
        cq, crf = layer.quant_rows(ctx)
        x1q, x1rf = layer.quant_rows(x1)
        hpart = h.abs().reshape(M, I // 128, 128).amax(dim=-1)
        for name, epi, a, w, b, kw in (
                ("qkv + bias", 0, xq, wqkv, bqkv, dict(rf=xrf)),
                ("attention out + LN + quantize x1", 2, cq, wo, bo,
                 dict(rf=crf, resid=x, ln_s=g1, ln_b=be1)),
                ("FFN in + GELU + h absmax", 1, x1q, w1, b1,
                 dict(rf=x1rf)),
                ("FFN out + LN + quantize h", 2, h, w2, b2,
                 dict(part=hpart, resid=x1, ln_s=g2, ln_b=be2))):
            # epi 2 on codes: attention out, which quantizes x1 (QOUT)
            quant_out = epi == 2 and a.dtype == torch.int8

            def gemm():
                return layer._gemm_i8(a, w, b, epi, dt=dt, **kw)
            got = gemm()
            codes_share = None
            if epi == 1:
                got, got_part = got
            if epi == 2:
                aq, arf = (a, kw["rf"]) if quant_out else layer.quant_rows(a)
                want = layer_norm(layer._mm_codes(aq, arf, *w) + b
                                  + kw["resid"].float(), kw["ln_s"],
                                  kw["ln_b"], 1e-12)
            else:
                want = layer._mm_codes(a, kw["rf"], *w) + b
                if epi == 1:
                    want = 0.5 * want * (1.0 + erf_poly(want * 2.0 ** -0.5))
                    # PART: exactly the absmax of what it wrote
                    codes_share = float((got_part == got.abs().reshape(
                        M, -1, 128).amax(dim=-1)).float().mean())
            if quant_out:
                got, got_q, got_rf = got
                want_q, want_rf = layer.quant_rows(got)
                codes_share = min(
                    float((got_q == want_q).float().mean()),
                    float((got_rf.view(torch.int32) == want_rf.view(
                        torch.int32)).float().mean()))
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            cos = float(_row_cos(got, want, w[0].shape[0]).min())
            ms = graph_ms(gemm)
            lib_a = a if a.dtype == torch.int8 else layer.quant_rows(a)[0]
            lib_ms = graph_ms(lambda: _int_mm(lib_a, w[0]))
            N, K = w[0].shape
            ops = 2 * M * N * K
            bd = bound(ops, "int8", nbytes(a, *w, b, kw.get("rf"),
                                           kw.get("part"), kw.get("resid"),
                                           kw.get("ln_s"), kw.get("ln_b"))
                       + M * N * (4 if epi == 1 or quant_out else 2)
                       + (M * N + 4 * M if quant_out else 0)
                       + (4 * M * N // 128 if epi == 1 else 0))
            shape = f"{name} M={M} K={K} N={N} s8"
            ok = cos >= KERNEL_COS_MIN and np.isfinite(err) and (
                codes_share is None or codes_share == 1.0)
            say(f"phase k4 gemm {shape}: max|d|={err:.3e} min row cos="
                f"{cos:.7f}" + ("" if codes_share is None else
                                f" codes/absmax equal share="
                                f"{codes_share:.6f}")
                + f" kernel {ms:.4f} ms ({ops / ms / 1e9:.0f} TOP/s) _int_mm "
                f"{lib_ms:.4f} ms bound {bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']})")
            if not ok:
                raise AssertionError(f"K4's GEMM disagrees with its plain "
                                     f"arithmetic at {shape}")
            rows.append({"shape": shape, "max_abs_err": err,
                         "min_row_cos": cos, "codes_equal_share": codes_share,
                         "ms": ms, **bd, "library_ms": lib_ms})
        del f32
    return rows


def phase_k4_rel(results: list, rng: np.random.Generator, dev) -> None:
    """K4 with MPNet's rel_bias at all-mpnet-base-v2's width vs
    bert_layer_i8_plain with the same operand (per-token cosine >=
    KERNEL_COS_MIN: the twin repeats the kernel's fixed-order attention),
    timed beside K4 without it on the same weights."""
    from dawnsearch_tpu_torch.ops import layer
    H, nh, I = BASE_W
    f32 = _layer_weights(rng, H, I, dev, dtype=torch.float32)
    k4w = [tuple(q.to(dev) for q in layer.i8_weight(t.cpu()))
           if t.ndim == 2 else t for t in f32]
    flat = [t for w in k4w for t in (w if isinstance(w, tuple) else (w,))]
    shapes = []
    for B, S in REL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((B, S, H), np.float32)
                             ).to(dev, torch.bfloat16)
        mask, bias = _ragged(rng, B, S, dev)
        rel = _rel_bias(rng, S, nh, dev)

        def k4(rel_bias=rel):
            return layer.fused_bert_layer_i8(x, bias, *k4w, nh=nh,
                                             eps=MPNET_EPS, rel_bias=rel_bias)
        got = k4()
        want = layer.bert_layer_i8_plain(x, bias, *k4w, nh=nh, eps=MPNET_EPS,
                                         rel_bias=rel)
        norel = k4(None)
        torch.cuda.synchronize()
        err, cos, finite = _token_check(got, want, mask)
        moved = _token_check(norel, want, mask)[1]
        ms = cuda_ms(k4)
        norel_ms = cuda_ms(lambda: k4(None))
        plain_ms = cuda_ms(lambda: layer.bert_layer_i8_plain(
            x, bias, *k4w, nh=nh, eps=MPNET_EPS, rel_bias=rel))
        bd = k4_bound(B, S, H, I, x, flat, rel)
        shape = f"B={B} S={S} H={H} nh={nh} I={I} bf16 W8A8 rel_bias"
        say(f"phase k4 {shape}: max|d|={err:.3e} min token cos={cos:.6f} "
            f"(without rel {moved:.4f}) kernel {ms:.3f} ms, without rel "
            f"{norel_ms:.3f} ms, plain {plain_ms:.3f} ms bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if not (finite and cos >= KERNEL_COS_MIN):
            raise AssertionError(f"K4 with rel_bias disagrees with its plain "
                                 f"version at {shape} (cos bound "
                                 f"{KERNEL_COS_MIN})")
        shapes.append({"shape": shape, "max_abs_err": err,
                       "min_token_cos": cos, "min_token_cos_without_rel": moved,
                       "ms": ms, "norel_ms": norel_ms, "plain_ms": plain_ms,
                       **bd, "library_ms": None})
    results.append({"name": "bert_layer_i8_rel", "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/attention.cu",
                    "replaces": "dawnsearch_tpu/ops/layer.py:275 (rel_bias)",
                    **shapes[0], "other_shapes": shapes[1:]})


def encode_base(rng: np.random.Generator, dev, family: str) -> None:
    """A 12-layer BERT-base or all-mpnet-base-v2 encoder (seeded weights,
    family "bert" or "mpnet") on K1 and on K4: device time of encode_batch
    at B = 1 and 64, S = 128, each the median of 10 CUDA-graph replays of 3
    calls, alternating the routes' order; the pooled cosine of the two
    routes' embeddings."""
    from dawnsearch_tpu_torch.models.bert import (BertConfig, BertModel,
                                                  encode_batch)
    from dawnsearch_tpu_torch.models.mpnet import MPNET_BASE, MPNetModel
    from dawnsearch_tpu_torch.models.weights import params_from_numpy
    H, nh, I = BASE_W
    if family == "mpnet":
        cfg, model_cls, name = MPNET_BASE, MPNetModel, "MPNet-base"
    else:
        cfg = BertConfig(hidden_size=H, num_heads=nh, intermediate_size=I,
                         num_layers=12)
        model_cls, name = BertModel, "BERT-base"
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    tree = params_from_numpy(_encoder_tree(rng, cfg))
    models = {impl: model_cls(dataclasses.replace(cfg, layer_impl=impl), tree,
                              device=dev) for impl in ("layer", "layer_i8")}
    del tree
    for B in (1, 64):
        ids = torch.from_numpy(rng.integers(1000, cfg.vocab_size, (B, 128))
                               ).to(dev)
        mask, _ = _ragged(rng, B, 128, dev)
        ids = torch.where(mask, ids, cfg.pad_token_id)
        mask = mask.int()
        embs = {k: encode_batch(m, ids, mask) for k, m in models.items()}
        cos = float((embs["layer"] * embs["layer_i8"]).sum(-1).min())
        ms: dict = {k: [] for k in models}
        for r in range(2):
            for impl in (("layer", "layer_i8") if r == 0 else
                         ("layer_i8", "layer")):
                ms[impl].append(graph_ms(lambda m=models[impl]: encode_batch(
                    m, ids, mask), calls=3))
        say(f"phase k4 encode {name} 12 layers B={B} S=128: K1 device "
            f"{ms['layer']} ms, K4 device {ms['layer_i8']} ms (K4/K1 "
            f"{np.median(ms['layer_i8']) / np.median(ms['layer']):.3f}); "
            f"min pooled cos K4 vs K1 {cos:.6f}")
        if not (all(bool(torch.isfinite(e).all()) for e in embs.values())
                and cos > 0.99):
            raise AssertionError(f"{name} encode on K1 and K4 disagree: "
                                 f"min cos {cos}")


def phase_k2(results: list) -> None:
    """K2 i8 (qi8) at 1,048,576 rows x 1024 queries (the entry's headline
    shape), then at B = 1 and 8 over the node's index (capacity 524,288,
    270,000 live rows: 15 of its 32 tiles wholly past count) and over
    1,048,576 rows; each bit-equal to the plain twin. The small batches
    are timed as device time (graph_ms): the host's launch work is not in
    it."""
    from dawnsearch_tpu_torch.index.flat import quantize_rows_i8
    from dawnsearch_tpu_torch.ops import scan_select as ss
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = _unit_rows(K2_ROWS, g, dev)
    queries = _unit_rows(K2_BATCH, g, dev)
    codes, scales = quantize_rows_i8(rows)
    count = K2_ROWS - 1000  # the count mask bites in the last tile
    shapes = []
    for N, live, B in ((K2_ROWS, count, K2_BATCH),
                       *((NODE_CAPACITY, NODE_PAGES, b) for b in SMALL_BATCHES),
                       *((K2_ROWS, count, b) for b in SMALL_BATCHES)):
        qq, qs = ss.quantize_queries(queries[:B])
        shapes.append(check_select(
            "k2", "select_i8", f"N={N} count={live} D=384 B={B} i8", qq, qs,
            codes[:N], scales[:N], live, rows[:N], queries[:B],
            timer=cuda_ms if B == K2_BATCH else graph_ms))
    results.append(select_entry("select_i8",
                                "dawnsearch_tpu/ops/scan_select.py:281",
                                shapes))


def select_entry(name: str, replaces: str, shapes: list) -> dict:
    """A select variant's kernels-line entry: its first shape's numbers,
    the others beside them."""
    return {"name": name, "route": "cuda",
            "source": "dawnsearch_tpu_torch/csrc/scan_select.cu",
            "replaces": replaces, **shapes[0], "other_shapes": shapes[1:]}


def select_bound(q, qs, codes, scales, count: int) -> dict:
    """2·B·count·D ops at the peak of the MMA type (int8 for i8 queries,
    bf16 otherwise); bytes: queries, the live rows' codes and scales, and
    the (B, N/128) values and ids."""
    B, D = q.shape
    rows = codes.shape[0] * (2 if codes.dtype == torch.uint8 else 1)
    code_bytes = nbytes(codes) * count / rows
    out_bytes = B * (rows // 128) * 8
    kind = "int8" if q.dtype == torch.int8 else "bf16"
    return bound(2 * B * count * D, kind,
                 nbytes(q, qs) + code_bytes + (4 * count if scales is not None
                                               else 0) + out_bytes)


def reranked_top(vals, ids, rows, queries, k: int = 10) -> torch.Tensor:
    """Fold candidates to k + 30 and re-rank them by exact f32 dot -> the
    (B, k) ids the serving path would return."""
    from dawnsearch_tpu_torch.ops import scan_select as ss
    _, cand = ss.fold_topk(vals, ids, k + 30)
    cand = cand.long()
    exact = torch.einsum("bd,bkd->bk", queries, rows[cand.clamp_min(0)])
    exact = torch.where(cand >= 0, exact, -torch.inf)
    return torch.gather(cand, 1, torch.topk(exact, k, dim=1).indices)


def check_select(phase: str, name: str, shape: str, q, qs, codes, scales,
                 count: int, rows, queries, timer=cuda_ms) -> dict:
    """One select variant vs its plain twin on the same inputs: bit-equal
    for i8 queries, within the bf16 tolerance otherwise; both timed with
    `timer`. Returns the shape's row of the kernels line."""
    from dawnsearch_tpu_torch.ops import scan_select as ss
    vals, ids = ss.select_candidates(q, qs, codes, scales, count)
    pvals, pids = ss.select_candidates_plain(q, qs, codes, scales, count)
    torch.cuda.synchronize()
    fin = torch.isfinite(vals) & torch.isfinite(pvals)
    err = float((vals - pvals)[fin].abs().max()) if bool(fin.any()) else 0.0
    same_fin = torch.equal(torch.isfinite(vals), torch.isfinite(pvals))
    share = float((ids == pids).float().mean())
    if q.dtype == torch.int8:
        ok = (torch.equal(vals.view(torch.int32), pvals.view(torch.int32))
              and torch.equal(ids, pids))
        agree = f"vals bit-equal={ok} ids equal share={share:.6f}"
    else:
        tops = reranked_top(vals, ids, rows, queries)
        ptops = reranked_top(pvals, pids, rows, queries)
        top_equal = torch.equal(tops, ptops)
        ok = (same_fin and err <= BF16_VAL_TOL and share >= BF16_ID_SHARE
              and top_equal)
        agree = (f"max|d|={err:.3e} (bound {BF16_VAL_TOL}) ids equal share="
                 f"{share:.6f} (bound {BF16_ID_SHARE}) re-ranked top-10 "
                 f"equal={top_equal}")
    del pvals, pids
    ms = timer(lambda: ss.select_candidates(q, qs, codes, scales, count))
    plain_ms = timer(lambda: ss.select_candidates_plain(q, qs, codes,
                                                        scales, count))
    bd = select_bound(q, qs, codes, scales, count)
    say(f"phase {phase} {name} {shape}: {agree}; kernel {ms:.4f} ms plain "
        f"{plain_ms:.3f} ms bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})"
        f"{' (device time)' if timer is graph_ms else ''}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}")
    return {"shape": shape, "max_abs_err": err, "ids_equal_share": share,
            "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def phase_k3(results: list) -> None:
    from dawnsearch_tpu_torch.ops import scan_select as ss
    from dawnsearch_tpu_torch.ops.quant import quantize_i4_vals, write_rows_i4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = _unit_rows(K2_ROWS, g, dev)
    queries = _unit_rows(K2_BATCH, g, dev)
    vals, scales = quantize_i4_vals(rows)
    codes = torch.zeros((K2_ROWS // 2, 384), dtype=torch.uint8, device=dev)
    write_rows_i4(codes, vals, 0)
    del vals
    count = K2_ROWS - 1000
    shapes = []
    for N, live, B in ((K2_ROWS, count, K2_BATCH),
                       *((NODE_CAPACITY, NODE_PAGES, b) for b in SMALL_BATCHES)):
        qq, qs = ss.quantize_queries(queries[:B])
        shapes.append(check_select(
            "k3", "select_i4", f"N={N} count={live} D=384 B={B} i4", qq, qs,
            codes[:N // 2], scales[:N], live, rows[:N], queries[:B],
            timer=cuda_ms if B == K2_BATCH else graph_ms))
    results.append(select_entry("select_i4",
                                "dawnsearch_tpu/ops/scan_select.py:221",
                                shapes))
    shape = f"N={K2_ROWS} D=384 B={K2_BATCH} i4 qi8=False"
    results.append(select_entry(
        "select_i4_qbf16", "dawnsearch_tpu/ops/scan_select.py:221",
        [check_select("k3", "select_i4_qbf16", shape, queries.bfloat16(),
                      None, codes, scales, count, rows, queries)]))


def phase_k2bf16(results: list) -> None:
    from dawnsearch_tpu_torch.index.flat import quantize_rows_i8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    rows = _unit_rows(K2_ROWS, g, dev)
    queries = _unit_rows(K2_BATCH, g, dev)
    count = K2_ROWS - 1000
    qb = queries.bfloat16()
    results.append(select_entry(
        "select_bf16", "dawnsearch_tpu/ops/scan_select.py:281",
        [check_select("k2bf16", "select_bf16",
                      f"N={K2_ROWS} D=384 B={K2_BATCH} bf16", qb, None,
                      rows.bfloat16(), None, count, rows, queries)]))
    codes, scales = quantize_rows_i8(rows)
    results.append(select_entry(
        "select_i8_qbf16", "dawnsearch_tpu/ops/scan_select.py:281",
        [check_select("k2bf16", "select_i8_qbf16",
                      f"N={K2_ROWS} D=384 B={K2_BATCH} i8 qi8=False", qb,
                      None, codes, scales, count, rows, queries)]))


def _ragged(rng: np.random.Generator, B: int, S: int, dev):
    """A (B, S) bool key mask with lengths in [S/8, S] (row 0 full) and
    its additive f32 bias."""
    lengths = rng.integers(max(1, S // 8), S + 1, B)
    lengths[0] = S
    mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
    return mask, torch.where(mask, 0.0, -1e30).float()


def _row_cos(got, want, width: int) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(
        got.float().reshape(-1, width), want.float().reshape(-1, width), dim=-1)


def _per_op_check(got, want, width: int) -> tuple[float, float, bool]:
    """K5-K7 against their twins: max |d|, min per-row cosine, and the
    bound of the output's dtype (bf16: cosine >= KERNEL_COS_MIN; f32: max
    |d| <= F32_REL_ERR_MAX of the output's scale and cosine >=
    F32_COS_MIN)."""
    got32, want32 = got.float(), want.float()
    err = float((got32 - want32).abs().max())
    cos = float(_row_cos(got32, want32, width).min())
    ok = bool(torch.isfinite(got32).all())
    if got.dtype == torch.float32:
        ok = ok and err <= F32_REL_ERR_MAX * float(want32.abs().max()) \
            and cos >= F32_COS_MIN
    else:
        ok = ok and cos >= KERNEL_COS_MIN
    return err, cos, ok


def _check_attention(tag: str, shape: str, kernel, plain, library, width,
                     flops: float, nbytes_: int) -> dict:
    """One attention kernel call vs its plain twin (per-row cosine, and
    max |d| in f32) and vs the library call; all three timed."""
    got, want = kernel(), plain()
    lib_out = library()
    torch.cuda.synchronize()
    err, cos, ok = _per_op_check(got, want, width)
    lib_cos = float(_row_cos(lib_out, want, width).min())
    ms, plain_ms, library_ms = (graph_ms(kernel), graph_ms(plain),
                                graph_ms(library))
    bd = bound(flops, _peak(got.dtype), nbytes_)
    say(f"phase attn {tag} {shape}: max|d|={err:.3e} min row cos={cos:.7f} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f}"
        f" ms (min row cos vs plain {lib_cos:.4f}) bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    if not ok:
        raise AssertionError(f"{tag} disagrees with its plain twin at {shape}")
    if not lib_cos >= 0.99:  # NaN fails too
        raise AssertionError(f"the library attention computes another "
                             f"function (row cos {lib_cos:.4f})")
    return {"shape": shape, "max_abs_err": err, "min_row_cos": cos, "ms": ms,
            "plain_ms": plain_ms, **bd, "library_ms": library_ms}


def phase_attn(results: list) -> None:
    """K5 reads q, k, v as column slices of one (B, S, 3H) projection
    output, as the encoder hands them over; K6 takes (B, nh, S, hd). Each
    in bf16 at every shape and in f32 (its f32 instance) at the first two.
    The library yardstick is scaled_dot_product_attention in the same
    dtype with the same key mask (the port never calls it)."""
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    attn_entries(results, rng, dev, K5_SHAPES, K6_SHAPES, torch.bfloat16)
    _f32_twins()
    attn_entries(results, rng, dev, K5_F32_SHAPES, K6_F32_SHAPES,
                 torch.float32)


def attn_entries(results: list, rng: np.random.Generator, dev, k5_shapes,
                 k6_shapes, dtype) -> None:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from dawnsearch_tpu_torch.ops import attention as at
    f32 = dtype == torch.float32
    sfx = "_f32" if f32 else ""

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(dev, dtype)
    packed = []
    for H, nh, B, S in k5_shapes:
        hd = H // nh
        qkv = randn(B, S, 3 * H)
        q, k, v = qkv.split(H, dim=-1)
        mask, bias = _ragged(rng, B, S, dev)

        def heads(t):
            return t.reshape(B, S, nh, hd).transpose(1, 2)
        out = torch.empty((B, S, H), dtype=dtype, device=dev)
        packed.append(_check_attention(
            "K5", f"B={B} S={S} H={H} hd={hd} {_tag(dtype)}",
            lambda: at.fused_attention_packed(q, k, v, bias, nh),
            lambda: at.attention_packed_plain(q, k, v, bias, nh),
            lambda: sdpa(heads(q), heads(k), heads(v),
                         attn_mask=mask[:, None, None, :]
                         ).transpose(1, 2).reshape(B, S, H),
            H, 4 * B * S * S * H, nbytes(qkv, bias, out)))
    results.append({"name": "attention_packed" + sfx, "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/attention.cu",
                    "replaces": "dawnsearch_tpu/ops/attention.py:198"
                                + (" (f32)" if f32 else ""),
                    **packed[0], "other_shapes": packed[1:]})
    head_major = []
    for H, nh, B, S in k6_shapes:
        hd = H // nh
        q, k, v = (randn(B, nh, S, hd) for _ in range(3))
        mask, bias = _ragged(rng, B, S, dev)
        out = torch.empty_like(q)
        head_major.append(_check_attention(
            "K6", f"B={B} S={S} nh={nh} hd={hd} {_tag(dtype)}",
            lambda: at.fused_attention(q, k, v, bias, nh),
            lambda: at.attention_plain(q, k, v, bias, nh),
            lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :]),
            hd, 4 * B * S * S * H, nbytes(q, k, v, bias, out)))
    results.append({"name": "attention" + sfx, "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/attention.cu",
                    "replaces": "dawnsearch_tpu/ops/attention.py:105"
                                + (" (f32)" if f32 else ""),
                    **head_major[0], "other_shapes": head_major[1:]})


def phase_ffn(results: list) -> None:
    """K7 at 64 x 128 rows for three widths and at one query's 128 rows in
    bf16, and at MiniLM and BERT-base widths and one query in f32 (its f32
    instance); no single PyTorch call computes the fused FFN + residual +
    LayerNorm, so library_ms is null and the composition of five calls is
    timed beside it (composition_ms)."""
    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    results.append(ffn_entry(rng, dev, FFN_SHAPES, torch.bfloat16))
    _f32_twins()
    results.append(ffn_entry(rng, dev, FFN_F32_SHAPES, torch.float32))


def ffn_composition(x, w1, b1, w2, b2, g, be, eps: float = 1e-12):
    """The FFN + residual + LayerNorm as five PyTorch calls in x's dtype:
    addmm, GELU (erf), addmm, the residual add, layer_norm. K7's
    yardstick only; the port never calls it."""
    F = torch.nn.functional
    h = F.gelu(torch.addmm(b1, x, w1))
    return F.layer_norm(torch.addmm(b2, h, w2) + x, (x.shape[1],), g, be, eps)


def ffn_entry(rng: np.random.Generator, dev, ffn_shapes, dtype) -> dict:
    """K7 (at f32 its matrices as tf32_pair pairs, as the model holds
    them) against ffn_plain on the (in, out) matrices, timed beside the
    plain twin and ffn_composition."""
    from dawnsearch_tpu_torch.ops import ffn
    shapes = []
    for M, H, I in ffn_shapes:
        x = torch.from_numpy(rng.standard_normal((M, H), np.float32)
                             ).to(dev, dtype)
        weights = _layer_weights(rng, H, I, dev, dtype)[6:]
        kw = _k1_form(weights)
        comp = [t.to(dtype) for t in weights]
        got = ffn.fused_ffn(x, *kw)
        want = ffn.ffn_plain(x, *weights)
        comp_out = ffn_composition(x, *comp)
        torch.cuda.synchronize()
        err, cos, ok = _per_op_check(got, want, H)
        comp_cos = float(_row_cos(comp_out, want, H).min())
        ms = graph_ms(lambda: ffn.fused_ffn(x, *kw))
        plain_ms = graph_ms(lambda: ffn.ffn_plain(x, *weights))
        comp_ms = graph_ms(lambda: ffn_composition(x, *comp))
        bd = bound(4 * M * H * I, _peak(x.dtype),
                   2 * nbytes(x) + nbytes(*weights))
        shape = f"M={M} H={H} I={I} {_tag(dtype)}"
        say(f"phase ffn {shape}: max|d|={err:.3e} min row cos={cos:.7f} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms composition "
            f"{comp_ms:.4f} ms (min row cos vs plain {comp_cos:.5f}) bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if not ok:
            raise AssertionError(f"K7 disagrees with ffn_plain at {shape}")
        shapes.append({"shape": shape, "max_abs_err": err, "min_row_cos": cos,
                       "ms": ms, "plain_ms": plain_ms, **bd,
                       "library_ms": None, "composition_ms": comp_ms})
    f32 = dtype == torch.float32
    return {"name": "ffn" + ("_f32" if f32 else ""), "route": "cuda",
            "source": "dawnsearch_tpu_torch/csrc/ffn.cu + "
                      "dawnsearch_tpu_torch/csrc/gemm.cuh",
            "replaces": "dawnsearch_tpu/ops/ffn.py:89"
                        + (" (f32)" if f32 else ""),
            **shapes[0], "other_shapes": shapes[1:]}


def _pool_stages(hidden, mask):
    """encode_batch's pool stage on a bf16 last hidden state and the
    encoder's int32 mask, three ways: K8 as this route runs it (no cast),
    the cast route (the hidden state and the mask cast to f32, then K8's
    f32 instance), and pool_impl="xla" (the cast, then mean_pool and
    normalize)."""
    from dawnsearch_tpu_torch.models.bert import mean_pool
    from dawnsearch_tpu_torch.ops import attention as at
    from dawnsearch_tpu_torch.ops.vector import normalize
    return {"fused": lambda: at.fused_mean_pool(hidden, mask),
            "cast_fused": lambda: at.fused_mean_pool(hidden.float(),
                                                     mask.float()),
            "xla": lambda: normalize(mean_pool(hidden.float(), mask),
                                     eps=1e-12)}


def phase_pool(results: list) -> None:
    """K8 on bf16 and f32 hidden states with the encoder's int32 mask,
    against mean_pool_plain; its bf16 result bit-equal to its f32 result
    on the upcast input and two calls bit-equal; timed beside the
    pool_impl="xla" composition (no single PyTorch call computes the
    masked mean + normalize) and beside a launch floor (K8 at B = S = 1,
    H = 8). Then encode_batch's pool stage at MiniLM's width (the K1
    route's last hidden state, bf16) at the node's buckets and B = 64,
    device and host time."""
    from dawnsearch_tpu_torch.ops import attention as at
    rng = np.random.default_rng(13)
    dev = torch.device("cuda")
    tiny = torch.ones((1, 1, 8), dtype=torch.bfloat16, device=dev)
    one = torch.ones((1, 1), dtype=torch.int32, device=dev)
    floor_ms = graph_ms(lambda: at.fused_mean_pool(tiny, one))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"phase pool: launch floor (K8 at B=1 S=1 H=8) {floor_ms:.4f} ms")
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H in POOL_SHAPES:
            hidden = torch.from_numpy(rng.standard_normal(
                (B, S, H), np.float32)).to(dev, dtype)
            mask = _ragged(rng, B, S, dev)[0].int()
            stages = _pool_stages(hidden, mask)
            for pad in (False, True) if (B, S, H) == POOL_SHAPES[0] else \
                    (False,):
                got = at.fused_mean_pool(hidden, mask, pad)
                want = at.mean_pool_plain(hidden, mask, pad)
                same = (torch.equal(got, at.fused_mean_pool(hidden, mask, pad))
                        and torch.equal(got, at.fused_mean_pool(
                            hidden.float(), mask, pad)))
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                norm_err = float((got.norm(dim=-1) - 1).abs().max())
                ok = err <= POOL_ERR_MAX and norm_err <= POOL_ERR_MAX and same
                ms = graph_ms(lambda: at.fused_mean_pool(hidden, mask, pad))
                plain_ms = graph_ms(lambda: at.mean_pool_plain(hidden, mask,
                                                               pad))
                comp_ms = None if pad else graph_ms(stages["xla"])
                bd = bound(2 * B * S * H, "f32",
                           nbytes(hidden, got) + (0 if pad else nbytes(mask)))
                shape = (f"B={B} S={S} H={H} {_tag(dtype)}"
                         f"{' include_padding' if pad else ''}")
                say(f"phase pool {shape}: plan {at.plan_pool(B, S, H, sms)}"
                    f" max|d|={err:.3e} max|norm-1|={norm_err:.3e} bits "
                    f"{'equal' if same else 'DIFFER'} (two calls, f32 of the "
                    f"same values) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                    f"composition {comp_ms} ms bound {bd['bound_ms']:.4f} ms "
                    f"({bd['bound_by']})")
                if not ok:
                    raise AssertionError(
                        f"K8 disagrees with mean_pool_plain at {shape} (bound "
                        f"{POOL_ERR_MAX}) or its bits moved: {err}, "
                        f"{norm_err}, {same}")
                shapes.append({"shape": shape, "max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, **bd, "library_ms": None,
                               "composition_ms": comp_ms})
    stages_out = []
    for B in POOL_STAGE_BATCHES:
        hidden = torch.from_numpy(rng.standard_normal(
            (B, 128, 384), np.float32)).to(dev, torch.bfloat16)
        mask = _ragged(rng, B, 128, dev)[0].int()
        stages = _pool_stages(hidden, mask)
        outs = {k: f() for k, f in stages.items()}
        err = max(float((o - outs["xla"]).abs().max()) for o in outs.values())
        if err > POOL_ERR_MAX:
            raise AssertionError(f"pool stages disagree at B={B}: {err}")
        row = {"B": B, "S": 128, "H": 384, "max_abs_err": err}
        for k, f in stages.items():
            row[k + "_ms"] = graph_ms(f)
            row[k + "_host_ms"] = _host_ms(f)
        say(f"phase pool stage B={B} S=128 H=384 bf16: " + "; ".join(
            f"{k} device {row[k + '_ms']:.4f} ms host "
            f"{row[k + '_host_ms']:.4f} ms" for k in stages))
        stages_out.append(row)
    results.append({"name": "mean_pool", "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/pool.cu",
                    "replaces": "dawnsearch_tpu/ops/attention.py:241",
                    **shapes[0], "launch_floor_ms": floor_ms,
                    "pool_stage": stages_out, "other_shapes": shapes[1:]})


def _unit_rows(n: int, g: torch.Generator, dev, dim: int = 384) -> torch.Tensor:
    v = torch.randn((n, dim), generator=g, device=dev)
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def index_recall(index, corpus, queries, kf: int, k: int = 10
                 ) -> tuple[float, float]:
    """recall@k of index.search against the exact top-k of the f32
    corpus: raw, and after an f32 re-rank of kf candidates."""
    truth_v = truth_i = None
    step = 1 << 20
    for s in range(0, corpus.shape[0], step):
        v, i = torch.topk(queries @ corpus[s:s + step].T, k, dim=1)
        i = i + s
        if truth_v is not None:
            v, sel = torch.topk(torch.cat([truth_v, v], 1), k, dim=1)
            i = torch.gather(torch.cat([truth_i, i], 1), 1, sel)
        truth_v, truth_i = v, i
    truth = truth_i.cpu().numpy()
    q_np = queries.cpu().numpy()
    _, raw = index.search(q_np, k)
    _, cand = index.search(q_np, kf)
    cand_t = torch.from_numpy(cand.astype(np.int64)).to(corpus.device)
    exact = torch.einsum("bd,bkd->bk", queries, corpus[cand_t.clamp_min(0)])
    exact = torch.where(cand_t >= 0, exact, -torch.inf)
    rr = torch.gather(cand_t, 1, torch.topk(exact, k, dim=1).indices).cpu().numpy()

    def recall(got):
        return float(np.mean([len(set(a) & set(b)) / k
                              for a, b in zip(got.tolist(), truth.tolist())]))
    return recall(raw), recall(rr)


def phase_recall(k: int = 10) -> None:
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    corpus = _unit_rows(K2_ROWS, g, dev)
    queries = _unit_rows(K2_BATCH, g, dev)
    index = FlatIndex(dim=384, dtype="i8", capacity=K2_ROWS,
                      max_capacity=K2_ROWS, device=dev)
    for s in range(0, K2_ROWS, 1 << 17):
        index.add(corpus[s:s + (1 << 17)])
    raw_r, rr_r = index_recall(index, corpus, queries, k + 30, k)
    say(f"phase recall N={K2_ROWS} Q={K2_BATCH}: recall@{k} raw={raw_r:.4f} "
        f"re-ranked={rr_r:.4f} (bounds {RAW_RECALL_MIN}, {RERANK_RECALL_MIN})")
    if raw_r < RAW_RECALL_MIN or rr_r < RERANK_RECALL_MIN:
        raise AssertionError("recall below bound")


def phase_recall_i4(k: int = 10) -> None:
    """i4 at 2M rows through host-packed adds, re-ranked at the i4
    ladder's width; bf16 at 1M rows through device adds, re-ranked at
    k + 30. Both must reach the i8 phase's re-ranked bound; bf16 also its
    raw bound (i4's raw recall is reported, not bounded)."""
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.ops import scan_select as ss
    from dawnsearch_tpu_torch.ops.quant import i4_fetch_width
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    queries = _unit_rows(K2_BATCH, g, dev)
    for dtype, n in (("i4", I4_RECALL_ROWS), ("bf16", K2_ROWS)):
        corpus = _unit_rows(n, g, dev)
        index = FlatIndex(dim=384, dtype=dtype, capacity=n, max_capacity=n,
                          device=dev)
        t0 = time.perf_counter()
        for s in range(0, n, 1 << 17):
            part = corpus[s:s + (1 << 17)]
            # i4: numpy blocks quantize and pack on the host
            index.add(part.cpu().numpy() if dtype == "i4" else part)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not index.fused_eligible():
            raise AssertionError(f"the {dtype} index does not take the fused path")
        kf = i4_fetch_width(n, k) if dtype == "i4" else k + 30
        name = ss.VARIANTS[(index._codes.dtype, dtype == "i4")]
        before = ss.launches[name]
        raw_r, rr_r = index_recall(index, corpus, queries, kf, k)
        ran = ss.launches[name] - before
        say(f"phase recall_i4 {dtype} N={n} Q={K2_BATCH}: built in "
            f"{build_s:.1f} s; recall@{k} raw={raw_r:.4f} re-ranked at "
            f"kf={kf} {rr_r:.4f} (bounds: re-ranked {RERANK_RECALL_MIN}"
            f"{'' if dtype == 'i4' else ', raw ' + str(RAW_RECALL_MIN)}); "
            f"{name} launches {ran}")
        if rr_r < RERANK_RECALL_MIN or ran == 0 or (
                dtype == "bf16" and raw_r < RAW_RECALL_MIN):
            raise AssertionError(f"{dtype} recall below bound or no kernel")
        del index, corpus
        torch.cuda.empty_cache()


def phase_i4_scale(extra: list) -> None:
    """The tier's capacity: 67,108,864 logical rows on one card, filled by
    device adds of seeded unit rows; the last row is a copy of query 0.
    Searched at B=1 and B=1024 (CUDA-event medians of the K3 launch and
    of the whole search_select)."""
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.ops import scan_select as ss
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    queries = _unit_rows(K2_BATCH, g, dev)
    N = I4_SCALE_ROWS
    t0 = time.perf_counter()
    index = FlatIndex(dim=384, dtype="i4", capacity=N, max_capacity=N,
                      device=dev)
    for s in range(0, N, I4_SCALE_ADD):
        rows = _unit_rows(I4_SCALE_ADD, g, dev)
        if s + I4_SCALE_ADD == N:
            rows[-1] = queries[0]  # the planted row, in the last tile
        index.add(rows)
        del rows
    torch.cuda.synchronize()
    say(f"phase i4_scale: {index.count} rows in {time.perf_counter() - t0:.1f}"
        f" s; codes {nbytes(index._codes) / 1e9:.2f} GB, scales "
        f"{nbytes(index._scales) / 1e9:.2f} GB")
    codes, scales, count = index._codes, index._scales, index.count
    for B in (1, K2_BATCH):
        q = queries[:B]
        d, i = ss.search_select(codes, scales, q, count, 10)
        ok = (bool((i >= 0).all()) and bool((i < count).all())
              and bool((d[:, 1:] >= d[:, :-1]).all())
              and int(i[0, 0]) == count - 1)
        qq, qs = ss.quantize_queries(q)
        ms = cuda_ms(lambda: ss.select_candidates(qq, qs, codes, scales,
                                                  count), reps=5, warmup=1)
        search_ms = cuda_ms(lambda: ss.search_select(codes, scales, q, count,
                                                     10), reps=5, warmup=1)
        bd = select_bound(qq, qs, codes, scales, count)
        say(f"phase i4_scale B={B}: ids in [0, count) and ascending "
            f"distances and planted row {count - 1} at rank 1: {ok} (rank 1 "
            f"= {int(i[0, 0])}, d={float(d[0, 0]):.5f}); K3 {ms:.3f} ms, "
            f"search_select {search_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
            f"({bd['bound_by']})")
        if not ok:
            raise AssertionError("i4_scale search returned a wrong result")
        extra.append({"shape": f"N={count} D=384 B={B} i4", "ms": ms,
                      "search_ms": search_ms, **bd})


def _host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host time of fn() followed by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_profile() -> None:
    """Split a text query on the node's default path (make_encoder,
    make_index_factory, FusedQueryPath) into host-timed stages, and read
    the device busy share and the top kernels from torch.profiler. The
    node's tokenizer must be the native one; its stage is timed beside the
    pure-Python tokenizer on the same texts, whose ids it must equal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.models.tokenizer import WordPieceTokenizer
    from dawnsearch_tpu_torch.models.tokenizer_native import \
        NativeWordPieceTokenizer
    from dawnsearch_tpu_torch.node import make_encoder, make_index_factory
    from dawnsearch_tpu_torch.ops import scan_select as ss
    from dawnsearch_tpu_torch.serving.fused import FusedQueryPath, _encode
    dev = torch.device("cuda")
    cfg = Config()
    enc = make_encoder(cfg)
    if not isinstance(enc.tokenizer, NativeWordPieceTokenizer):
        raise AssertionError(f"the node tokenizes with "
                             f"{type(enc.tokenizer).__name__}, not the "
                             f"native tokenizer")
    py_tok = WordPieceTokenizer(enc.tokenizer.vocab)
    max_seq = enc.seq_buckets[-1]
    index = make_index_factory(cfg)()
    g = torch.Generator(device=dev).manual_seed(5)
    for s in range(0, NODE_PAGES, 1 << 16):
        index.add(_unit_rows(min(1 << 16, NODE_PAGES - s), g, dev))
    path = FusedQueryPath(enc, index)
    if not ss.eligible(index.count, index.capacity, index.dim, index.dtype,
                       index.fused_min_rows):
        raise AssertionError("the profiled index does not take the K2 path")
    say(f"phase profile: i8 index of {index.count} rows, capacity "
        f"{index.capacity}, k={PROFILE_K}, host medians of 20 calls")
    for B in PROFILE_BATCHES:
        texts = [TEXTS[j % len(TEXTS)] for j in range(B)]
        ids, mask, real = enc.pad_counted(enc.tokenize_texts(texts))
        py_ids, _ = enc.pad_batch([py_tok.encode(x, max_len=max_seq)
                                   for x in texts])
        if not np.array_equal(ids, py_ids):
            raise AssertionError(f"native and Python token ids differ at "
                                 f"B={B}")
        emb = _encode(enc, ids, mask, real)

        def query():
            emb, d, i, k_eff = path.dispatch(texts, PROFILE_K)
            return path.finalize(emb, d, i, B, PROFILE_K, k_eff)
        _, dists, _ = query()
        if not np.isfinite(dists).all():
            raise AssertionError(f"non-finite distances at B={B}")
        t = {"query": _host_ms(query),
             "tokenize": _host_ms(lambda: enc.pad_batch(
                 enc.tokenize_texts(texts))),
             "tokenize_python": _host_ms(lambda: enc.pad_batch(
                 [py_tok.encode(x, max_len=max_seq) for x in texts])),
             "encode": _host_ms(lambda: _encode(enc, ids, mask, real)),
             "select": _host_ms(lambda: ss.search_select(
                 index._codes, index._scales, emb, index.count, PROFILE_K))}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                query()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        busy_us = sum(e.self_device_time_total for e in kernels)
        busy = (f"{busy_us / wall_us:.3f}" if busy_us > 0
                else "not measured (no device time in the trace)")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        say(f"phase profile B={B} (bucket {ids.shape[0]} x S={ids.shape[1]}): "
            + " ".join(f"{n} {v:.3f} ms" for n, v in t.items())
            + f"; device busy share {busy}; top kernels " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total / e.count:.1f} us x"
            f"{e.count // 10}" for e in top))


def _encoder_launches() -> list:
    """The encoder kernels' launch counters in this process: one dict,
    keyed by METRICS name, per wrapper module."""
    from dawnsearch_tpu_torch.ops import attention, ffn, layer
    return [layer.launches, attention.launches, ffn.launches]


def _counters() -> dict:
    return {k: n for launches in _encoder_launches()
            for k, n in launches.items()}


def _zero_counters() -> None:
    for launches in _encoder_launches():
        launches.update(dict.fromkeys(launches, 0))


def _encoder_tree(rng: np.random.Generator, cfg) -> dict:
    """Seeded weights in the reference's stacked layout for cfg's family:
    matrices with std 0.05, biases and LayerNorm parameters away from their
    init, MPNet's relative-position table with std 0.5, RoBERTa's position
    table a random walk (std 0.05)."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1
                ).astype(np.float32)
    mpnet = cfg.model_type == "mpnet"  # no token types, a (32, nh) table
    emb = {"word": w(cfg.vocab_size, H),
           "position": w(cfg.max_position_embeddings, H)}
    if cfg.model_type == "roberta":
        # a trained RoBERTa's position table changes slowly from one
        # position to the next, so shifting a text by one token (the "\n"
        # after a page's empty title) moves its embedding little; the
        # seeded table keeps that as a random walk along the positions
        walk = np.cumsum(emb["position"], axis=0)
        emb["position"] = ((walk - walk.mean(0)) / walk.std() * 0.05
                           ).astype(np.float32)
    if not mpnet:
        emb["token_type"] = w(cfg.type_vocab_size, H)
    tree = {
        "embeddings": {**emb, "ln_scale": v(H, base=1.0), "ln_bias": v(H)},
        "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                   "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                   "attn_ln_scale": v(L, H, base=1.0), "attn_ln_bias": v(L, H),
                   "ffn_in_w": w(L, H, I), "ffn_in_b": v(L, I),
                   "ffn_out_w": w(L, I, H), "ffn_out_b": v(L, H),
                   "ffn_ln_scale": v(L, H, base=1.0), "ffn_ln_bias": v(L, H)}}
    if mpnet:
        tree["rel_bias"] = v(cfg.relative_attention_num_buckets,
                             cfg.num_heads) * 5.0
    return tree


def phase_ops(counts: dict) -> None:
    """The per-op encoder through SentenceEncoder.encode, the entry point
    the node's batcher calls, on the smoke texts. Each configuration runs
    on the card with every encoder counter set to 0 just before and read
    just after, and is held to the same encoder on the CPU (plain twins,
    same weights). Adds each kernel's launches to `counts`."""
    from dawnsearch_tpu_torch.models.bert import BertConfig, encode_batch
    from dawnsearch_tpu_torch.models.encoder import SentenceEncoder
    from dawnsearch_tpu_torch.models.mpnet import MPNET_BASE
    from dawnsearch_tpu_torch.models.tokenizer import (WordPieceTokenizer,
                                                       build_vocab_from_corpus)
    from dawnsearch_tpu_torch.models.tokenizer_bpe_native import \
        NativeByteLevelBPETokenizer
    from dawnsearch_tpu_torch.models.weights import params_from_numpy
    from dawnsearch_tpu_torch.serving.fused import _encode
    dev = torch.device("cuda")
    corpus = [string.ascii_lowercase, string.digits,
              "the quick brown fox jumps over the lazy dog"]
    vocab = build_vocab_from_corpus(corpus, size=4096)
    mp_vocab = _mpnet_layout(sorted(vocab, key=vocab.get))
    toks = {"bert": WordPieceTokenizer(vocab), "mpnet": WordPieceTokenizer(
        {t: i for i, t in enumerate(mp_vocab)}),
        "roberta": NativeByteLevelBPETokenizer(*bpe_vocab(TEXTS))}
    minilm = dict(vocab_size=len(vocab), dtype=torch.bfloat16)
    tiny = dict(minilm, **TINYBERT)
    # all-mpnet-base-v2's width and family at 2 layers
    mpnet = dict(dataclasses.asdict(MPNET_BASE), vocab_size=len(mp_vocab),
                 num_layers=2, dtype=torch.bfloat16)
    # all-distilroberta-v1's width and family at 2 layers
    roberta = dict(dataclasses.asdict(roberta_config(num_layers=2)),
                   dtype=torch.bfloat16)
    f32 = dict(dtype=torch.float32)
    # (label, config, counters that must rise; every other encoder counter
    # must stay 0)
    k1, k4 = "kernel_bert_layer", "kernel_bert_layer_i8"
    runs = (
        ("minilm layer", dict(minilm), {k1}),
        # K1's route with K8 as its pool: K8 reads the bf16 last hidden state
        ("minilm layer+fused pool", dict(minilm, pool_impl="fused"),
         {k1, "kernel_mean_pool"}),
        ("minilm layer_i8", dict(minilm, layer_impl="layer_i8"), {k4}),
        ("minilm ops+fused pool", dict(minilm, layer_impl="ops",
                                       pool_impl="fused"),
         {"kernel_attention_packed", "kernel_ffn", "kernel_mean_pool"}),
        ("minilm ops", dict(minilm, layer_impl="ops"),
         {"kernel_attention_packed", "kernel_ffn"}),
        ("minilm attn_impl=xla", dict(minilm, attn_impl="xla"),
         {"kernel_ffn"}),
        ("tinybert layer", dict(tiny, layer_impl="layer"),
         {"kernel_attention", "kernel_ffn"}),
        # under MPNet's position bias the per-op path takes einsum
        # attention, never K5 or K6 (as the reference does), and K7
        ("mpnet ops", dict(mpnet, layer_impl="ops"), {"kernel_ffn"}),
        # RoBERTa: BERT's layer on K1, offset position ids, byte-level BPE
        ("roberta layer", dict(roberta), {k1}),
        # compute_dtype = "f32": the f32 instances of the same routes
        ("minilm layer f32", dict(minilm, **f32), {k1 + "_f32"}),
        ("minilm ops+fused pool f32", dict(minilm, layer_impl="ops",
                                           pool_impl="fused", **f32),
         {"kernel_attention_packed_f32", "kernel_ffn_f32",
          "kernel_mean_pool"}),
        ("tinybert layer f32", dict(tiny, layer_impl="layer", **f32),
         {"kernel_attention_f32", "kernel_ffn_f32"}),
    )
    trees = {}
    embs, encoders = {}, {}
    for label, kw, up in runs:
        cfg = BertConfig(**kw)
        tok = toks[cfg.model_type]
        key = (cfg.model_type, cfg.hidden_size, cfg.num_layers)
        if key not in trees:
            trees[key] = params_from_numpy(_encoder_tree(
                np.random.default_rng(cfg.hidden_size), cfg))
        enc = SentenceEncoder(trees[key], tok, cfg=cfg, device=dev)
        _zero_counters()
        emb = enc.encode(TEXTS)
        ran = _counters()
        for name, n in ran.items():
            counts[name] = counts.get(name, 0) + n
        cpu = SentenceEncoder(trees[key], tok, cfg=cfg,
                              device="cpu").encode(TEXTS)
        cos = float(np.min(np.sum(emb * cpu, axis=1)))
        err = float(np.abs(emb - cpu).max())
        rose = {n: c for n, c in ran.items() if c}
        # f32: the reference's f32 atol 1e-4 (K4's route is not run at f32
        # here); bf16: its cosine bound
        f32_ok = cfg.dtype != torch.float32 or err <= F32_ERR_MAX
        say(f"phase ops {label}: H={cfg.hidden_size} layers={cfg.num_layers}"
            f", {len(TEXTS)} texts; min cos vs CPU {cos:.7f}, max|d| "
            f"{err:.3e}; counters that rose {rose}")
        zero = set(ENCODER_COUNTERS) - up
        if not (np.isfinite(emb).all() and cos >= COS_MIN and f32_ok
                and all(ran[n] for n in up) and not any(ran[n] for n in zero)):
            raise AssertionError(f"ops {label}: cos {cos} (bound {COS_MIN}), "
                                 f"max|d| {err} or a wrong route: {ran}")
        embs[label], encoders[label] = emb, enc
    for label in ("minilm layer+fused pool", "minilm layer_i8",
                  "minilm ops+fused pool", "minilm ops",
                  "minilm attn_impl=xla"):
        cos = float(np.min(np.sum(embs[label] * embs["minilm layer"], axis=1)))
        say(f"phase ops {label} vs the K1 path: min cos {cos:.6f}")
        if cos < COS_MIN:
            raise AssertionError(f"ops {label} vs K1: cos {cos}")
    # encode time at S=128 on the K1 and the per-op paths: device time of
    # encode_batch (CUDA-graph replays, no host work in it), and host time
    # of _encode (host-to-device copy included) in ENCODE_ROUNDS rounds
    # that alternate the paths' order, as median [min, max] of the rounds
    labels = ("minilm layer", "minilm layer+fused pool",
              "minilm ops+fused pool", "minilm ops", "minilm attn_impl=xla",
              "minilm layer f32", "minilm ops+fused pool f32")
    for B in ENCODE_BATCHES:
        texts = [TEXTS[j % len(TEXTS)] for j in range(B)]
        enc = encoders["minilm layer"]
        ids, mask, real = enc.pad_counted(
            [t[:128] for t in enc.tokenize_texts(texts)])
        ids_d, mask_d = enc.to_device(ids, mask)
        device = {label: graph_ms(lambda e=encoders[label]: encode_batch(
            e.model, ids_d, mask_d, mask_padding=e.mask_padding,
            include_padding=e.include_padding_in_pool), calls=5)
            for label in labels}
        host: dict = {label: [] for label in labels}
        for r in range(ENCODE_ROUNDS):
            for label in labels[r % len(labels):] + labels[:r % len(labels)]:
                host[label].append(_host_ms(
                    lambda: _encode(encoders[label], ids, mask, real),
                    reps=10))
        say(f"phase ops encode B={B} S={ids.shape[1]}: " + "; ".join(
            f"{label} device {device[label]:.3f} ms, host "
            f"{np.median(host[label]):.3f} [{min(host[label]):.3f}, "
            f"{max(host[label]):.3f}] ms" for label in labels))


def swarm_corpus(directory: str, n_pages: int = SWARM_PAGES,
                 n_files: int = SWARM_FILES, seed: int = 23) -> list:
    """n_pages English HTML pages in n_files gzip WARC files written by the
    port's write_warc, as Common Crawl serves them: unique URLs, a title,
    1-4 KB of text opening with a sentence no other page has, then seeded
    prose on the page's own topic (a dozen words of the smoke texts'
    vocabulary, a third stopwords, so the English filter keeps every
    page). Returns the files' paths."""
    from dawnsearch_tpu_torch.ingest.warc import write_warc
    rng = np.random.default_rng(seed)
    content, stop = np.array(CONTENT), np.array(STOPWORDS)
    paths = []
    for f in range(n_files):
        records = []
        for i in range(f, n_pages, n_files):
            n = int(rng.integers(180, 700))
            topic = rng.choice(content, 12, replace=False)
            words = np.where(rng.random(n) < 0.35, rng.choice(stop, n),
                             rng.choice(topic, n))
            w = rng.choice(content, 4)
            text = (f"Page {i} tells of the {w[0]} and the {w[1]} near the "
                    f"{w[2]} {w[3]}. " + " ".join(words) + ".")
            body = (f"<html><head><title>{w[3]} {w[0]} {i}</title></head>"
                    f"<body><nav><a href='/'>home</a></nav><article><p>"
                    f"{text}</p></article></body></html>")
            records.append((f"https://crawl{f}.example/{w[1]}/{i}",
                            body.encode()))
        path = os.path.join(directory, f"CC-SMOKE-{f:05d}.warc.gz")
        write_warc(path, records)
        paths.append(path)
    return paths


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, body: dict | None = None, timeout: float = 120.0) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def seed_store(data_dir: str, n: int, dim: int = 384, seed: int = 4) -> None:
    """A page store of n synthetic pages: seeded unit embeddings of `dim`,
    ids contiguous from 1."""
    from dawnsearch_tpu_torch.index.provider import DB_FILE
    from dawnsearch_tpu_torch.index.store import PageStore
    rng = np.random.default_rng(seed)
    store = PageStore(os.path.join(data_dir, DB_FILE), dim=dim)
    try:
        for s in range(0, n, 16384):
            e = rng.standard_normal((min(16384, n - s), dim), np.float32)
            e /= np.linalg.norm(e, axis=1, keepdims=True)
            store.insert_batch([(f"https://synthetic.example/{s + j}", "",
                                 f"synthetic page {s + j}", v)
                                for j, v in enumerate(e)])
    finally:
        store.close()


def _bert_vocab(size: int) -> list:
    """A BERT-layout vocab of `size` lines: the specials at BERT's
    positions, the smoke texts' words, then [unusedN] filler."""
    from dawnsearch_tpu_torch.models.tokenizer import build_vocab_from_corpus
    specials = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    words = [w for w in build_vocab_from_corpus(TEXTS) if w not in specials]
    vocab = specials + words
    return vocab + [f"[unused{i}]" for i in range(99, 99 + size - len(vocab))]


def _mpnet_layout(body: list) -> list:
    """all-mpnet-base-v2's vocab layout: <s> <pad> </s> <unk>, a whole BERT
    vocab (its literal [PAD], [CLS], [SEP], [UNK] included), <mask> last."""
    return ["<s>", "<pad>", "</s>", "<unk>", *body, "<mask>"]


def roberta_config(**kw):
    """all-distilroberta-v1's shape (ROBERTA_CONFIG) as the port's
    BertConfig; kw overrides fields (depth, compute policy)."""
    from dawnsearch_tpu_torch.models.bert import BertConfig
    c = ROBERTA_CONFIG
    shape = dict(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                 num_layers=c["num_hidden_layers"],
                 num_heads=c["num_attention_heads"],
                 intermediate_size=c["intermediate_size"],
                 max_position_embeddings=c["max_position_embeddings"],
                 type_vocab_size=c["type_vocab_size"],
                 layer_norm_eps=c["layer_norm_eps"], model_type="roberta",
                 pad_token_id=c["pad_token_id"])
    return BertConfig(**{**shape, **kw})


def bpe_vocab(texts) -> tuple[dict, list]:
    """A byte-level BPE vocab and merge list in all-distilroberta-v1's
    layout for `texts` (lowercase ASCII words between single spaces):
    <s> <pad> </s> <unk>, the 256 byte symbols, each pre-token's
    left-to-right merge chain, <mask> last. The chains of the `Ġword`
    pre-tokens (a word after a space) rank first, so each of them is one
    token; a text's bare first word follows. Built by construction,
    because train_bpe needs the `regex` module."""
    from dawnsearch_tpu_torch.models.tokenizer_bpe import byte_to_unicode
    b2u = byte_to_unicode()
    for text in texts:
        if set(text) - set(string.ascii_lowercase + " ") or "  " in text:
            raise ValueError(f"not lowercase words between single spaces: "
                             f"{text!r}")
    words = [text.split(" ") for text in texts]
    pieces = ([b2u[ord(" ")] + w for ws in words for w in ws[1:]]
              + [ws[0] for ws in words])
    symbols = ["<s>", "<pad>", "</s>", "<unk>"] + [b2u[b] for b in range(256)]
    known, merges = set(symbols), []
    for piece in pieces:
        left = piece[0]
        for ch in piece[1:]:
            if left + ch not in known:
                merges.append((left, ch))
                symbols.append(left + ch)
                known.add(left + ch)
            left += ch
    symbols.append("<mask>")
    return {t: i for i, t in enumerate(symbols)}, merges


def write_checkpoint(model_dir: str, family: str, seed: int = 15) -> None:
    """A checkpoint as a user drops one into model_dir: the published
    config.json (bert-base-uncased's for "base", all-MiniLM-L6-v2's for
    "minilm", all-mpnet-base-v2's for "mpnet", all-distilroberta-v1's for
    "roberta"), model.safetensors (seeded layers at full width, 12, or
    MiniLM's and RoBERTa's 6, written by the port's
    own writer) and the family's vocab: a vocab.txt of the config's size in
    the family's layout holding the smoke texts' words, or for "roberta"
    vocab.json + merges.txt from bpe_vocab."""
    from dawnsearch_tpu_torch.models.bert import BertConfig
    from dawnsearch_tpu_torch.models.mpnet import MPNET_BASE
    from dawnsearch_tpu_torch.models.tokenizer_bpe import ByteLevelBPETokenizer
    from dawnsearch_tpu_torch.models.weights import (params_from_numpy,
                                                     save_safetensors)
    vocab = None
    if family == "roberta":
        c, cfg = ROBERTA_CONFIG, roberta_config()
    elif family == "mpnet":
        c, cfg = MPNET_CONFIG, MPNET_BASE
        vocab = _mpnet_layout(_bert_vocab(c["vocab_size"] - 5))
    else:
        c = MINILM_CONFIG if family == "minilm" else BERT_BASE_CONFIG
        cfg = BertConfig(vocab_size=c["vocab_size"],
                         hidden_size=c["hidden_size"],
                         num_layers=c["num_hidden_layers"],
                         num_heads=c["num_attention_heads"],
                         intermediate_size=c["intermediate_size"])
        vocab = _bert_vocab(c["vocab_size"])
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    save_safetensors(params_from_numpy(_encoder_tree(
        np.random.default_rng(seed), cfg)),
        os.path.join(model_dir, "model.safetensors"), cfg)
    if vocab is None:
        ByteLevelBPETokenizer(*bpe_vocab(TEXTS)).save(model_dir)
        return
    assert len(vocab) == c["vocab_size"]
    with open(os.path.join(model_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")


def seeded_store(work: str, stores: dict, dim: int,
                 n_pages: int = NODE_PAGES) -> str:
    """The seeded store of `dim` dims in `work`, made once (seed_store);
    each run starts on a copy of it."""
    if dim not in stores:
        stores[dim] = os.path.join(work, f"seed-{dim}")
        os.makedirs(stores[dim])
        t0 = time.perf_counter()
        seed_store(stores[dim], n_pages, dim)
        say(f"seeded {n_pages} pages of {dim} dims in "
            f"{time.perf_counter() - t0:.1f} s")
    return stores[dim]


def run_nodes(work: str, stores: dict, runs=NODE_RUNS) -> dict:
    """Run the node once per entry of `runs`, each on a copy of a seeded
    store as wide as its encoder (a copy holds no index snapshot, so each
    run builds its own index); the BERT-base, MPNet and RoBERTa runs serve
    a checkpoint of their family, each written once. Every run must
    tokenize natively: its log's "encoder ready" line names the C++
    tokenizer's class. Returns every kernel counter's increase, summed
    over runs."""
    total: dict = {}
    for label, tier, env, up, model in runs:
        env = dict(env)
        dim = 384
        if model is not None:
            model_dir = os.path.join(work, f"model-{model}")
            if not os.path.exists(model_dir):
                t0 = time.perf_counter()
                write_checkpoint(model_dir, model)
                say(f"phase node: wrote a {model} checkpoint in "
                    f"{time.perf_counter() - t0:.1f} s")
            env["DAWNSEARCH_MODEL_DIR"] = model_dir
            dim = 768
        data_dir = os.path.join(work, label)
        shutil.copytree(seeded_store(work, stores, dim), data_dir)
        tok = ("NativeByteLevelBPETokenizer" if model == "roberta"
               else "NativeWordPieceTokenizer")
        for name, n in run_node(data_dir, label, tier, env, up,
                                tok).items():
            total[name] = total.get(name, 0) + n
        shutil.rmtree(data_dir, ignore_errors=True)
    return total


def start_node(work: str, label: str, data_dir: str, env_extra: dict):
    """`python -m dawnsearch_tpu_torch --web` as a user starts it, on
    `data_dir` with the extra environment, its output in
    work/node-<label>.log. Returns (process, base URL, log path, log file)
    at once; wait_up() waits for its front end."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=HERE, **env_extra)
    log_path = os.path.join(work, f"node-{label}.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dawnsearch_tpu_torch", "--config",
         os.path.join(work, "absent.toml"), "--web", "--data-dir", data_dir,
         "--listen", f"127.0.0.1:{port}"],
        cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path, log


def wait_up(proc, base: str, timeout: float = 600.0) -> dict:
    """Poll /api/stats until it answers; returns the stats."""
    deadline = time.monotonic() + timeout
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"node exited with {proc.returncode}")
        try:
            return _http(base + "/api/stats", timeout=5)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def stop_process(proc, what: str, timeout: float = 300.0) -> None:
    """SIGTERM, then require exit status 0."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=timeout)
    if rc != 0:
        raise RuntimeError(f"{what} exit code {rc} after SIGTERM")


def _log_lines(log_path: str, needle: str) -> list:
    with open(log_path, encoding="utf-8") as f:
        return [line.strip() for line in f if needle in line]


def run_node(data_dir: str, label: str, tier: str, env_extra: dict,
             up: tuple, tokenizer: str, start_timeout: float = 600.0) -> dict:
    """Start the node as a user would on `data_dir` with index_dtype
    `tier` and the extra environment, insert, query, read the kernel
    counters, stop. Returns the counters' increase; fails unless its log
    names `tokenizer` as the encoder's, the encoder counters `up` and the
    tier's select ran and every other encoder counter did not. Prints the
    server time of the first query beside the median of the others (a
    node without warmup builds and loads lazily on its first requests)."""
    from dawnsearch_tpu_torch.ops.scan_select import VARIANTS
    work = os.path.dirname(data_dir)
    t0 = time.perf_counter()
    proc, base, log_path, log = start_node(
        work, label, data_dir, {"DAWNSEARCH_ACCEPT_INSERT": "true",
                                "DAWNSEARCH_INDEX_DTYPE": tier, **env_extra})
    try:
        stats = wait_up(proc, base, start_timeout)
        say(f"phase node {label}: up in {time.perf_counter() - t0:.1f} s, "
            f"{stats['pages_indexed']} pages, capacity {stats['index_capacity']}")
        ready = _log_lines(log_path, "encoder ready")
        say(f"phase node {label}: {ready[0] if ready else 'no encoder line'}")
        if len(ready) != 1 or f"tokenizer={tokenizer})" not in ready[0]:
            raise AssertionError(f"the node's encoder does not tokenize "
                                 f"with {tokenizer}: {ready}")
        names = (*ENCODER_COUNTERS, *VARIANTS.values())
        before = _http(base + "/api/metrics")
        # only a warmed-up node has launched kernels, its route's encoder
        # kernels, before the first request; counts below are increases
        warm = "DAWNSEARCH_WARMUP" in env_extra
        started = {n: before[n] for n in names if before.get(n, 0)}
        if set(started) - (set(up) if warm else set()):
            raise AssertionError(f"kernel counters not zero at start: {before}")
        if warm:
            say(f"phase node {label}: warmup launched {started} before the "
                f"first request")
        pages = [{"url": f"https://pages.example/{j}", "title": "", "text": t}
                 for j, t in enumerate(TEXTS)]
        ins = _http(base + "/api/insert", {"pages": pages})
        if len(ins["inserted"]) != len(TEXTS):
            raise AssertionError(f"insert: {ins}")
        seconds = []
        for j in QUERIED:
            res = _http(base + "/api/search?q=" + urllib.parse.quote(TEXTS[j]))
            top = res["results"]
            dists = [round(r["distance"], 5) for r in top[:3]]
            seconds.append(float(res["seconds"]))
            say(f"phase node {label}: query {j} -> {top[0]['url']} top-3 distances "
                f"{dists} ({res['seconds']} s)")
            if top[0]["url"] != pages[j]["url"]:
                raise AssertionError(f"page {j} not at rank 1: {top[:3]}")
        say(f"phase node {label}: first query {seconds[0] * 1e3:.1f} ms, the "
            f"other {len(seconds) - 1} median {np.median(seconds[1:]) * 1e3:.1f}"
            f" ms ({'warmup = true' if warm else 'no warmup'})")
        after = _http(base + "/api/metrics")
        counts = {n: after.get(n, 0) - before.get(n, 0) for n in names}
        if env_extra.get("DAWNSEARCH_INDEX_KIND") == "sharded":
            # after the counts: the capture's queries are not the path's
            check_sharded_node(label, base)
        say(f"phase node {label}: kernel launches "
            f"{ {n: c for n, c in counts.items() if c} }")
        zero = set(ENCODER_COUNTERS) - set(up)
        if not (all(counts[n] for n in (*up, NODE_SELECT[tier]))
                and not any(counts[n] for n in zero)):
            raise AssertionError(f"a kernel of the path never ran, or one "
                                 f"off the path did: {counts}")
        stop_process(proc, "node")
        say(f"phase node {label}: stopped cleanly in "
            f"{time.perf_counter() - t0:.1f} s total")
        return counts
    except BaseException:
        log.flush()
        with open(log_path) as f:
            sys.stderr.write("--- node log (tail) ---\n" + f.read()[-6000:])
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()


# kernel names (csrc/) in a torch.profiler trace: K1's GEMM ring and
# attention, K2's select
TRACE_KERNELS = {"K1": ("gemm_kernel", "attention_kernel"),
                 "K2": ("select_kernel",)}


def check_sharded_node(label: str, base: str) -> None:
    """The sharded node's extras, after its timed queries and its kernel
    counts: its inserts took ShardedFusedIngestPath (METRICS'
    fused_ingest_dispatch timer), and an /api/profile capture, taken
    while more queries run (the profiler slows every op it records),
    names K1's and K2's kernels. The capture's queries are counted apart
    and printed; their launches are not the path's."""
    metrics = _http(base + "/api/metrics")
    stats = _http(base + "/api/stats")
    profiled: dict = {}
    capture = threading.Thread(target=lambda: profiled.update(
        _http(base + "/api/profile?seconds=1")))
    capture.start()
    queries = 0
    while capture.is_alive():  # keep queries inside the capture
        _http(base + "/api/search?q=" + urllib.parse.quote(TEXTS[0]))
        queries += 1
    capture.join()
    if not metrics.get("fused_ingest_dispatch_count"):
        raise AssertionError("the sharded node's inserts did not take "
                             "ShardedFusedIngestPath")
    with open(profiled["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    found = {k: [n for n in kernels if any(p in n for p in pats)]
             for k, pats in TRACE_KERNELS.items()}
    say(f"phase node {label}: {stats['pages_indexed']} pages in the sharded "
        f"index, inserts through ShardedFusedIngestPath "
        f"({metrics['fused_ingest_dispatch_count']} dispatches); /api/profile "
        f"during {queries} queries wrote {os.path.basename(profiled['trace'])} "
        f"({os.path.getsize(profiled['trace']) >> 10} KiB, {len(events)} "
        f"events, {len(kernels)} kernel names) naming K1 "
        f"{len(found['K1'])} and K2 {len(found['K2'])} times")
    if not all(found.values()):
        raise AssertionError(f"the profile trace names no K1 or no K2 "
                             f"kernel: {sorted(kernels)[:20]}")


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_time(line: str) -> float:
    """The time of a log line ("2026-01-02 03:04:05,678 ..."), in s."""
    day, clock = line.split()[:2]
    return time.mktime(time.strptime(f"{day} {clock[:8]}",
                                      "%Y-%m-%d %H:%M:%S")) + \
        int(clock[9:12]) / 1e3


@contextlib.contextmanager
def plain_k1():
    """The encoder with K1 swapped for its plain twin (bert_layer_plain,
    the same torch ops on the same device): the plain path of an encode on
    the card. No K1 launch is counted inside it."""
    from dawnsearch_tpu_torch.models import bert
    from dawnsearch_tpu_torch.ops import layer
    k1, before = bert.fused_bert_layer, dict(layer.launches)
    bert.fused_bert_layer = layer.bert_layer_plain
    try:
        yield
    finally:
        bert.fused_bert_layer = k1
    if layer.launches != before:
        raise AssertionError("a kernel ran on the plain path")


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def phase_swarm(work: str, stores: dict, dev: dict, counts: dict) -> None:
    """A tracker and two nodes over loopback UDP, started as a user starts
    them, on a seeded all-MiniLM-L6-v2 checkpoint (bf16, i8 index): node B
    on a copy of the 270,000-page store ingests SWARM_FILES gzip WARC files
    (index_cc, warc_source, 2 extraction workers) through K1; node A, empty,
    answers text queries for ingested pages through B (K2 on B's index).
    Then the embeddings B stored, and those of the sidecar CLI, against the
    same encoder on the plain path. Adds both nodes' kernel counters to
    `counts`."""
    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.index.provider import DB_FILE
    from dawnsearch_tpu_torch.ingest import native
    from dawnsearch_tpu_torch.ingest.pages import iter_pages
    from dawnsearch_tpu_torch.ingest.sidecar import load_sidecar
    from dawnsearch_tpu_torch.node import make_encoder
    from dawnsearch_tpu_torch.ops.scan_select import VARIANTS
    rng = np.random.default_rng(31)
    t0 = time.perf_counter()
    corpus = os.path.join(work, "swarm-warc")
    os.makedirs(corpus)
    paths = swarm_corpus(corpus)
    t1 = time.perf_counter()
    pages = {}
    for path in paths:
        for p in iter_pages(path):
            pages[p.url] = (p.title, p.text)
    say(f"phase swarm: wrote {SWARM_PAGES} pages in {len(paths)} gzip WARC "
        f"files ({sum(os.path.getsize(p) for p in paths) / 2**20:.1f} MiB) in "
        f"{t1 - t0:.1f} s; iter_pages keeps {len(pages)} in "
        f"{time.perf_counter() - t1:.1f} s, readers {native.readers()}")
    model_dir = os.path.join(work, "model-minilm")
    write_checkpoint(model_dir, "minilm")
    data_b = os.path.join(work, "swarm-b")
    data_a = os.path.join(work, "swarm-a")
    shutil.copytree(seeded_store(work, stores, 384), data_b)
    tport = _free_udp_port()
    peer = {"DAWNSEARCH_MODEL_DIR": model_dir, "DAWNSEARCH_UDP": "true",
            "DAWNSEARCH_TRACKERS": f"127.0.0.1:{tport}",
            "DAWNSEARCH_ANNOUNCE_INTERVAL_S": "2",
            "DAWNSEARCH_ACCEPT_INSERT": "false"}
    procs, logs = [], []
    try:
        t_log = open(os.path.join(work, "tracker.log"), "w")
        logs.append(t_log)
        tracker = subprocess.Popen(
            [sys.executable, "-m", "dawnsearch_tpu_torch", "track",
             "--listen", f"127.0.0.1:{tport}"], cwd=work, stdout=t_log,
            stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=HERE))
        procs.append(("tracker", tracker))
        deadline = time.monotonic() + 120
        while not _log_lines(t_log.name, "tracker on"):
            if tracker.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the tracker did not start")
            time.sleep(0.2)
        t0 = time.perf_counter()
        b, base_b, log_b, f_b = start_node(work, "swarm-b", data_b, {
            **peer, "DAWNSEARCH_UDP_LISTEN_ADDRESS":
                f"127.0.0.1:{_free_udp_port()}",
            "DAWNSEARCH_INDEX_CC": "true",
            "DAWNSEARCH_WARC_SOURCE": os.path.join(corpus, "*.warc.gz"),
            "DAWNSEARCH_INGEST_WORKERS": "2"})
        procs.append(("node B", b))
        logs.append(f_b)
        a, base_a, log_a, f_a = start_node(work, "swarm-a", data_a, {
            **peer, "DAWNSEARCH_UDP_LISTEN_ADDRESS":
                f"127.0.0.1:{_free_udp_port()}"})
        procs.append(("node A", a))
        logs.append(f_a)
        stats_b = wait_up(b, base_b)
        say(f"phase swarm: node B up in {time.perf_counter() - t0:.1f} s, "
            f"{stats_b['pages_indexed']} pages")
        want = NODE_PAGES + len(pages)
        deadline = time.monotonic() + 600
        while stats_b["pages_indexed"] < want:
            if b.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"node B stopped at "
                                   f"{stats_b['pages_indexed']} of {want}")
            time.sleep(0.25)
            stats_b = _http(base_b + "/api/stats")
        ready = _log_lines(log_b, "ingest ready")
        done = [ln for ln in _log_lines(log_b, "ingested ")
                if f"total {len(pages)})" in ln]
        encoder = _log_lines(log_b, "encoder ready")
        for line in (*encoder, *ready, *_log_lines(log_b, "ingest: ")):
            say(f"phase swarm: node B: {line}")
        if not (len(encoder) == 1
                and "tokenizer=NativeWordPieceTokenizer)" in encoder[0]
                and len(ready) == 1 and "workers=2" in ready[0] and done):
            raise AssertionError("node B's log does not name its native "
                                 "tokenizer, its readers and 2 workers")
        seconds = _log_time(done[0]) - _log_time(ready[0])
        say(f"phase swarm: node B ingested {len(pages)} pages in "
            f"{seconds:.2f} s from 'ingest ready': "
            f"{len(pages) / seconds:.1f} pages/s ({dev['smi']})")
        metrics = _http(base_b + "/api/metrics")
        # per batch: tokenize (host), enqueue the encode and index write,
        # wait for the embeddings (device), SQLite write, and the whole
        # insert_pages call around the last three
        for name in ("ingest_tokenize", "fused_ingest_dispatch",
                     "fused_ingest", "ingest_store", "ingest_insert"):
            say(f"phase swarm: node B stage {name}: p50 "
                f"{metrics.get(name + '_p50_ms', float('nan')):.2f} ms, p99 "
                f"{metrics.get(name + '_p99_ms', float('nan')):.2f} ms over "
                f"{metrics.get(name + '_count', 0)} batches")
        time.sleep(1.0)
        if _http(base_b + "/api/stats")["pages_indexed"] != want:
            raise AssertionError("node B ingested more than the corpus")
        wait_up(a, base_a)
        urls = sorted(pages)
        sample = [urls[i] for i in rng.choice(len(urls), SWARM_QUERIES + 1,
                                              replace=False)]

        def query(base: str, url: str) -> tuple:
            title, text = pages[url]
            res = _http(base + "/api/search?q="
                        + urllib.parse.quote(f"{title}\n{text}"))
            top = res["results"][0] if res["results"] else None
            return res, top

        res, top = query(base_b, sample[0])  # B warms up on its own index
        if top is None or top["url"] != sample[0]:
            raise AssertionError(f"node B's own query: {top}")
        say(f"phase swarm: node B's warm-up query {res['seconds'] * 1e3:.1f} "
            f"ms, {res['pages_searched']} pages searched")
        # A's first query that reaches B is its warm-up; A learns B from
        # the tracker within an announce interval
        for tries in range(1, 31):
            res, top = query(base_a, sample[0])
            if res["instances_contacted"] == 2:
                break
            time.sleep(0.5)
        b_id = stats_b["instance_id"]
        from_b = top is not None and top["instance_id"] == b_id
        say(f"phase swarm: node A's first remote query (try {tries}): "
            f"{res['seconds'] * 1e3:.1f} ms, rank 1 "
            f"{top['url'] if top else None} ({'B' if from_b else 'not B'}), "
            f"{res['instances_contacted']} instances contacted")
        if res["instances_contacted"] != 2:
            raise AssertionError("node A never reached node B")
        before = _http(base_b + "/api/metrics")
        times = []
        for url in sample[1:]:
            res, top = query(base_a, url)
            times.append(res["seconds"])
            if top is None or top["url"] != url or top["instance_id"] != b_id:
                raise AssertionError(f"{url} not at rank 1 from node B: "
                                     f"{res['results'][:2]}")
        after_b = _http(base_b + "/api/metrics")
        after_a = _http(base_a + "/api/metrics")
        raised = (after_b.get("kernel_select", 0)
                  - before.get("kernel_select", 0))
        say(f"phase swarm: {len(times)} pages queried from A, each at rank 1 "
            f"from B: {np.median(times) * 1e3:.1f} ms median "
            f"[{min(times) * 1e3:.1f}, {max(times) * 1e3:.1f}] "
            f"({dev['smi']}); B's kernel_select rose by {raised}")
        names = (*ENCODER_COUNTERS, *VARIANTS.values())
        for label, m in (("A", after_a), ("B", after_b)):
            got = {n: m[n] for n in names if m.get(n)}
            say(f"phase swarm: node {label} kernel launches {got}")
            for n, c in got.items():
                counts[n] = counts.get(n, 0) + c
        if not (raised >= len(times) and after_a.get("kernel_bert_layer")
                and after_b.get("kernel_bert_layer")):
            raise AssertionError("K2 on B or K1 on a node did not run")
        for label, proc in procs[::-1]:
            stop_process(proc, label)
        say(f"phase swarm: tracker and both nodes stopped cleanly, exit 0")
        procs.clear()
        # the sidecar CLI on one file, beside the plain-path check of B's
        # stored embeddings
        s_log = open(os.path.join(work, "sidecar.log"), "w")
        logs.append(s_log)
        sidecar = subprocess.Popen(
            [sys.executable, "-m", "dawnsearch_tpu_torch", "--config",
             os.path.join(work, "absent.toml"), "sidecar", paths[0]],
            cwd=work, stdout=s_log, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=HERE,
                     DAWNSEARCH_MODEL_DIR=model_dir))
        procs.append(("sidecar", sidecar))
        db = sqlite3.connect(os.path.join(data_b, DB_FILE))
        stored = {url: (title, text, np.frombuffer(e, "<f4"))
                  for url, title, text, e in db.execute(
                      "SELECT url, title, text, embedding FROM page "
                      "WHERE id > ?", (NODE_PAGES,))}
        db.close()
        if len(stored) != len(pages) or any(
                stored[u][:2] != pages[u] for u in pages):
            raise AssertionError("node B's store does not hold iter_pages' "
                                 "pages")
        cfg = Config.load(None)  # DAWNSEARCH_* as the nodes read them
        cfg.model_dir = model_dir
        enc = make_encoder(cfg)
        check = [urls[i] for i in rng.choice(len(urls), SWARM_CHECKED,
                                             replace=False)]
        with plain_k1():
            plain = enc.encode([f"{stored[u][0]}\n{stored[u][1]}"
                                for u in check])
        cos = _cos(np.stack([stored[u][2] for u in check]), plain)
        say(f"phase swarm: {len(check)} of B's stored embeddings (K1 at the "
            f"ingest batches) vs the plain path: min cos {cos.min():.7f}")
        if cos.min() < COS_MIN:
            raise AssertionError(f"stored embeddings off the plain path: "
                                 f"min cos {cos.min()}")
        rc = sidecar.wait(timeout=600)
        procs.clear()
        if rc != 0:
            raise RuntimeError(f"sidecar CLI exit code {rc}")
        emb, s_urls = load_sidecar(paths[0].rsplit(".warc", 1)[0]
                                   + ".sidecar.npz")[:2]
        cos = _cos(emb, np.stack([stored[str(u)][2] for u in s_urls]))
        say(f"phase swarm: sidecar CLI wrote {len(s_urls)} pages of "
            f"{os.path.basename(paths[0])}; vs B's stored embeddings min cos "
            f"{cos.min():.7f}")
        if len(s_urls) != sum(u.startswith("https://crawl0.") for u in pages) \
                or cos.min() < COS_MIN:
            raise AssertionError("the sidecar does not hold B's embeddings")
    except BaseException:
        for f in logs:
            f.flush()
            with open(f.name) as g:
                sys.stderr.write(f"--- {f.name} (tail) ---\n"
                                 + g.read()[-4000:])
        raise
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for f in logs:
            f.close()


def _planted_queries(rows: torch.Tensor, n: int, g: torch.Generator
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """n queries near stored rows (row + 0.3 · noise, normalized), so each
    query's nearest row is its planted one -> (queries, planted ids)."""
    planted = torch.randint(0, rows.shape[0], (n,), generator=g,
                            device=rows.device)
    q = rows[planted] + 0.3 * _unit_rows(n, g, rows.device, rows.shape[1])
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True), planted


def _merged_raw(ix, q: torch.Tensor, k: int
                ) -> tuple[np.ndarray, np.ndarray, bool]:
    """A sharded index's raw K2 / K3 result (no re-rank): each shard's
    select against its plain twin on the same inputs (bit-equal for the
    i8 queries both select variants score), then the merge. -> (distances
    and user ids (B, k), every shard bit-equal)."""
    from dawnsearch_tpu_torch.ops import scan_select as ss
    from dawnsearch_tpu_torch.parallel.sharded_index import merge_shards
    ds, us, equal = [], [], True
    qq, qs = ss.quantize_queries(q)
    for s in range(ix.mesh.local_shards):
        codes, scales = ix._codes[0][s], ix._scales[0][s]
        count = int(ix._counts[s])
        vals, ids = ss.select_candidates(qq, qs, codes, scales, count)
        pvals, pids = ss.select_candidates_plain(qq, qs, codes, scales, count)
        equal &= (torch.equal(vals.view(torch.int32), pvals.view(torch.int32))
                  and torch.equal(ids, pids))
        d, i = ss.fold_topk(vals, ids, k)
        uid = torch.where(i >= 0, ix._ids[0][s][i.clamp_min(0).long()], -1)
        ds.append(d)
        us.append(uid)
    d, u = merge_shards(torch.stack(ds), torch.stack(us), k)
    return d.cpu().numpy(), u.cpu().numpy(), equal


def _same_or_better(d, u, fd, fu) -> tuple[np.ndarray, bool]:
    """Per query: the sharded ids equal the flat index's, else its
    distances are nowhere worse (it kept a row the flat index's candidate
    fold dropped). -> (equal rows, every row equal or better)."""
    same = np.all(u == fu, axis=1)
    better = np.all(d <= fd + 1e-6, axis=1)
    return same, bool((same | better).all())


def phase_sharded(notes: dict) -> None:
    """ShardedFlatIndex of SHARDED_SHARDS shards on cuda:0 over
    SHARDED_ROWS seeded unit rows (262,144 a shard: the K2 gate), i8 and
    i4, each with its f16 shadow, against a FlatIndex over the same rows
    at B = 1, 8 and 32, queries near planted rows: every shard's select
    bit-equal to its plain twin; the planted row first; the top-10 ids,
    raw and after the f16 re-rank, equal to the flat index's on every
    query or nowhere worse by distance, and equal on at least
    SHARDED_EQUAL_SHARE of the 41 queries after the re-rank (the flat
    index folds its 8192 candidate columns once, pairing
    tile t with t + 32 and keeping the better column; a 262,144-row shard's
    2048 columns are not folded, so it can keep a top-10 row the fold
    drops); timed against the flat index (CUDA-event medians). Then the i8
    index saved, reloaded on 4 shards and re-striped onto 2, with equal
    results."""
    from dawnsearch_tpu_torch.index import load_index
    from dawnsearch_tpu_torch.index.flat import FlatIndex
    from dawnsearch_tpu_torch.ops import scan_select as ss
    from dawnsearch_tpu_torch.parallel.mesh import make_mesh
    from dawnsearch_tpu_torch.parallel.sharded_index import ShardedFlatIndex
    dev = torch.device("cuda", 0)
    mesh = make_mesh({"shard": SHARDED_SHARDS}, devices=[dev] * SHARDED_SHARDS)
    g = torch.Generator(device=dev).manual_seed(21)
    rows = _unit_rows(SHARDED_ROWS, g, dev)
    queries, planted = _planted_queries(rows, max(SHARDED_BATCHES), g)
    rows_np = rows.cpu().numpy()
    del rows
    planted = planted.cpu().numpy()
    k = 10
    for dtype, variant in (("i8", "kernel_select"), ("i4", "kernel_select_i4")):
        t0 = time.perf_counter()
        flat = FlatIndex(dtype=dtype, exact="f16", device=dev)
        flat.add(rows_np)
        sh = ShardedFlatIndex(mesh=mesh, dtype=dtype, exact="f16")
        sh.add(rows_np)
        torch.cuda.synchronize()
        say(f"phase sharded {dtype}: built flat and {SHARDED_SHARDS}-shard "
            f"indexes of {SHARDED_ROWS} rows in "
            f"{time.perf_counter() - t0:.1f} s; shard counts "
            f"{sh._counts.tolist()}, capacity {sh.cap_per_shard} a shard")
        if not (sh.fused_eligible() and flat.fused_eligible()):
            raise AssertionError("the sharded or flat index is below the "
                                 "fused gate")
        before = ss.launches[variant]
        n_same = 0
        for B in SHARDED_BATCHES:
            q = queries[:B]
            sd, su = sh.search(q, k)
            fd, fu = flat.search(q, k)
            same, ok = _same_or_better(sd, su, fd, fu)
            rd, ru, bit_equal = _merged_raw(sh, q, k)
            frd, fru = (t.cpu().numpy() for t in ss.search_select(
                flat._codes, flat._scales, q, flat.count, k))
            raw_same, raw_ok = _same_or_better(rd, ru, frd, fru)
            first = bool((ru[:, 0] == planted[:B]).all()
                         and (su[:, 0] == planted[:B]).all())
            sh_ms = cuda_ms(lambda: sh.search_dispatch(q, k))
            flat_ms = cuda_ms(lambda: flat.search_dispatch(q, k))
            say(f"phase sharded {dtype} B={B}: f16 re-ranked ids equal the "
                f"flat index's on {int(same.sum())}/{B} queries (the rest "
                f"nowhere worse: {ok}); raw: every shard bit-equal to its "
                f"plain twin={bit_equal}, equal on {int(raw_same.sum())}/{B} "
                f"(the rest nowhere worse: {raw_ok}), planted row first="
                f"{first}; search (f16 re-rank) sharded {sh_ms:.3f} ms, flat "
                f"{flat_ms:.3f} ms")
            notes[f"sharded_{dtype}_B{B}"] = {
                "sharded_ms": sh_ms, "flat_ms": flat_ms,
                "reranked_equal": int(same.sum()),
                "raw_equal": int(raw_same.sum()), "B": B}
            if not (ok and raw_ok and bit_equal and first):
                raise AssertionError(f"sharded {dtype} B={B} disagrees with "
                                     "the flat index (see the line above)")
            n_same += int(same.sum())
        if n_same < SHARDED_EQUAL_SHARE * sum(SHARDED_BATCHES):
            raise AssertionError(f"sharded {dtype}: re-ranked ids equal the "
                                 f"flat index's on only {n_same} queries")
        ran = ss.launches[variant] - before
        # each search: one launch a shard (sharded), one (flat); _merged_raw
        # adds one a shard
        if ran < len(SHARDED_BATCHES) * (2 * SHARDED_SHARDS + 1):
            raise AssertionError(f"{variant} ran {ran} times")
        if dtype == "i8":
            work = tempfile.mkdtemp(prefix="dawn-sharded-")
            path = os.path.join(work, "sharded.npz")
            t0 = time.perf_counter()
            sh.save(path)
            q = queries[:32]
            want = sh.search(q, k)[1]
            four = load_index(path, mesh=mesh)
            two = load_index(path, mesh=make_mesh({"shard": 2},
                                                  devices=[dev] * 2))
            for got in (four, two):
                if not np.array_equal(got.search(q, k)[1], want):
                    raise AssertionError(f"reloaded on {got.n_shards} shards: "
                                         "results differ")
            say(f"phase sharded i8: saved {os.path.getsize(path) >> 20} MiB, "
                f"reloaded on 4 shards and re-striped onto 2 "
                f"({two._counts.tolist()}), equal ids at B=32, in "
                f"{time.perf_counter() - t0:.1f} s")
            shutil.rmtree(work, ignore_errors=True)
            del four, two
        del flat, sh
        torch.cuda.empty_cache()


def _crew_port() -> int:
    """A free port whose successor (the control stream) is free too."""
    while True:
        port = _free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue


def _launches_logged(log_path: str) -> dict:
    lines = _log_lines(log_path, "follower stopped; kernel launches")
    if not lines:
        raise AssertionError("the follower logged no kernel launches")
    return json.loads(lines[-1].split("kernel launches", 1)[1])


def _rebuild_rate(log_path: str) -> tuple[int, float]:
    """(rows, seconds) of the provider's "rebuilt index" log line."""
    line = _log_lines(log_path, "rebuilt index:")[-1]
    words = line.split("rebuilt index:", 1)[1].split()
    return int(words[0]), float(words[3].rstrip("s"))


def phase_crew(work: str, counts: dict, notes: dict) -> None:
    """Two processes on cuda:0 over gloo, started as a user starts them:
    the leader `python -m dawnsearch_tpu_torch --web` (DawnNode,
    dist_process_id 0), the follower `python -m dawnsearch_tpu_torch`
    with dist_process_id 1, index_kind "sharded" (one shard a process),
    index_rerank "device". The leader rebuilds CREW_ROWS seeded pages
    through the crew (coalesced adds; K2 then runs in both processes),
    ingests TEXTS through /api/insert (K1 on the leader), answers
    CREW_QUERIES of them over HTTP at rank 1, and saves through the gather;
    SIGTERM stops both with exit 0. The crew's snapshot must load in one
    process on 4 shards and on the crew's 2 with equal results. Adds both
    processes' kernel counters to `counts`."""
    from dawnsearch_tpu_torch.index import load_index
    from dawnsearch_tpu_torch.index.provider import DB_FILE, INDEX_FILE
    from dawnsearch_tpu_torch.parallel.mesh import make_mesh
    data_dir = os.path.join(work, "crew")
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    seed_store(data_dir, CREW_ROWS)
    say(f"phase crew: seeded {CREW_ROWS} pages in "
        f"{time.perf_counter() - t0:.1f} s")
    env = {"DAWNSEARCH_INDEX_KIND": "sharded",
           "DAWNSEARCH_INDEX_RERANK": "device",
           "DAWNSEARCH_ACCEPT_INSERT": "true",
           "DAWNSEARCH_DIST_COORDINATOR": f"127.0.0.1:{_crew_port()}",
           "DAWNSEARCH_DIST_NUM_PROCESSES": "2"}
    fol_log_path = os.path.join(work, "crew-follower.log")
    fol_log = open(fol_log_path, "w")
    follower = subprocess.Popen(
        [sys.executable, "-m", "dawnsearch_tpu_torch", "--config",
         os.path.join(work, "absent.toml"), "--data-dir", data_dir],
        cwd=work, env=dict(os.environ, PYTHONPATH=HERE, **env,
                           DAWNSEARCH_DIST_PROCESS_ID="1"),
        stdout=fol_log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    leader, base, log_path, log = start_node(
        work, "crew-leader", data_dir, {**env, "DAWNSEARCH_DIST_PROCESS_ID": "0"})
    try:
        stats = wait_up(leader, base)
        rebuilt, secs = _rebuild_rate(log_path)
        say(f"phase crew: leader up in {time.perf_counter() - t0:.1f} s, "
            f"{stats['pages_indexed']} pages; rebuilt {rebuilt} rows through "
            f"the crew in {secs:.2f} s ({rebuilt / secs:.0f} rows/s, adds "
            f"coalesced at dist_add_flush_rows)")
        if follower.poll() is not None:
            raise RuntimeError(f"follower exited with {follower.returncode}")
        names = (*ENCODER_COUNTERS, "kernel_select")
        before = _http(base + "/api/metrics")
        pages = [{"url": f"https://pages.example/{j}", "title": "", "text": t}
                 for j, t in enumerate(TEXTS)]
        if len(_http(base + "/api/insert", {"pages": pages})["inserted"]) \
                != len(TEXTS):
            raise AssertionError("crew insert refused pages")
        seconds = []
        for j in range(CREW_QUERIES):
            res = _http(base + "/api/search?q=" + urllib.parse.quote(TEXTS[j]))
            seconds.append(float(res["seconds"]))
            if res["results"][0]["url"] != pages[j]["url"]:
                raise AssertionError(f"crew: page {j} not at rank 1: "
                                     f"{res['results'][:3]}")
        med = float(np.median(seconds[1:]))
        say(f"phase crew: {CREW_QUERIES} queries at rank 1; first "
            f"{seconds[0] * 1e3:.1f} ms, the others median {med * 1e3:.1f} ms")
        notes["crew"] = {"query_median_ms": med * 1e3,
                         "rebuild_rows_per_s": rebuilt / secs}
        t1 = time.perf_counter()
        _http(base + "/api/save", {})
        say(f"phase crew: saved through the gather in "
            f"{time.perf_counter() - t1:.2f} s")
        after = _http(base + "/api/metrics")
        stop_process(leader, "crew leader")
        rc = follower.wait(timeout=300)
        if rc != 0:
            raise RuntimeError(f"follower exit code {rc}")
        lead = {n: after.get(n, 0) - before.get(n, 0) for n in names}
        fol = _launches_logged(fol_log_path)
        say(f"phase crew: leader launches (insert + queries) "
            f"{ {n: c for n, c in lead.items() if c} }, follower launches "
            f"(its whole run) {fol}")
        if not (lead["kernel_bert_layer"] and lead["kernel_select"]
                and fol.get("kernel_select")):
            raise AssertionError("K1 on the leader or K2 in either process "
                                 "never ran")
        for n in names:
            counts[n] = counts.get(n, 0) + lead[n] + fol.get(n, 0)
        # the crew's snapshot in one process: on its own 2 shards and
        # re-striped onto 4, against the stored embeddings of the pages
        dev = torch.device("cuda", 0)
        db = sqlite3.connect(os.path.join(data_dir, DB_FILE))
        got = db.execute("SELECT id, embedding FROM page WHERE url LIKE "
                         "'https://pages.example/%' ORDER BY id").fetchall()
        db.close()
        ids = np.array([r[0] for r in got]) - 1
        embs = np.stack([np.frombuffer(r[1], "<f4") for r in got])
        path = os.path.join(data_dir, INDEX_FILE)
        res = {}
        for n in (2, 4):
            ix = load_index(path, mesh=make_mesh({"shard": n},
                                                 devices=[dev] * n))
            res[n] = ix.search(embs, 10)[1]
            say(f"phase crew: snapshot loaded on {n} shards in one process: "
                f"{len(ix)} rows, counts {ix._counts.tolist()}")
            del ix
        if not (np.array_equal(res[2], res[4])
                and (res[2][:, 0] == ids).all()):
            raise AssertionError("the crew's snapshot does not reload with "
                                 "equal results")
        say("phase crew: its snapshot reloads with equal results, every "
            "inserted page first")
    except BaseException:
        for f, p in ((log, log_path), (fol_log, fol_log_path)):
            f.flush()
            with open(p) as fh:
                sys.stderr.write(f"--- {p} (tail) ---\n" + fh.read()[-6000:])
        raise
    finally:
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        log.close()
        fol_log.close()
        shutil.rmtree(data_dir, ignore_errors=True)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    labels = [r[0] for r in NODE_RUNS]
    ap.add_argument("--node-runs", default=",".join(labels),
                    help=f"phase node's runs, a comma-separated subset of "
                         f"{','.join(labels)}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    node_runs = args.node_runs.split(",")
    if set(node_runs) - set(labels):
        ap.error(f"unknown node runs {sorted(set(node_runs) - set(labels))}")
    full = set(phases) == set(PHASES) and set(node_runs) == set(labels)

    dev = phase_device()  # always: nothing runs without a GPU
    sys.path.insert(0, HERE)
    import dawnsearch_tpu_torch  # noqa: F401  (fails outside a checkout)
    results: list = []
    if set(phases) & KERNEL_PHASES:
        phase_build()
    scale: list = []
    ops_counts: dict = {}
    notes: dict = {}  # the sharded and crew phases' times
    for name, run in (("k1", lambda: phase_k1(results)),
                      ("k4", lambda: phase_k4(results)),
                      ("k2", lambda: phase_k2(results)),
                      ("k3", lambda: phase_k3(results)),
                      ("k2bf16", lambda: phase_k2bf16(results)),
                      ("attn", lambda: phase_attn(results)),
                      ("ffn", lambda: phase_ffn(results)),
                      ("pool", lambda: phase_pool(results)),
                      ("recall", phase_recall),
                      ("recall_i4", phase_recall_i4),
                      ("i4_scale", lambda: phase_i4_scale(scale)),
                      ("profile", phase_profile),
                      ("ops", lambda: phase_ops(ops_counts)),
                      ("sharded", lambda: phase_sharded(notes))):
        if name in phases:
            t0 = time.perf_counter()
            run()
            torch.cuda.empty_cache()
            say(f"phase {name}: done in {time.perf_counter() - t0:.1f} s")
    # launches are counted only in the runs of the main path (the nodes,
    # the ops phase's encoders and the swarm's nodes); a partial run
    # without them has no such count
    node_counts: dict = {}
    swarm_counts: dict = {}
    crew_counts: dict = {}
    work = tempfile.mkdtemp(prefix="dawn-smoke-")
    try:
        stores: dict = {}  # seeded stores, shared by the node runs and swarm
        if "node" in phases:
            t0 = time.perf_counter()
            node_counts = run_nodes(work, stores, [r for r in NODE_RUNS
                                                   if r[0] in node_runs])
            say(f"phase node: done in {time.perf_counter() - t0:.1f} s")
        if "swarm" in phases:
            t0 = time.perf_counter()
            phase_swarm(work, stores, dev, swarm_counts)
            say(f"phase swarm: done in {time.perf_counter() - t0:.1f} s")
        if "crew" in phases:
            t0 = time.perf_counter()
            phase_crew(work, crew_counts, notes)
            say(f"phase crew: done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in results:
        counter = COUNTER[r["name"]]
        ran = [c[counter] for c in (node_counts, ops_counts, swarm_counts,
                                    crew_counts) if counter in c]
        r["launches"] = sum(ran) if ran else None
        r["launches_node"] = node_counts.get(counter)
        r["launches_ops"] = ops_counts.get(counter)
        r["launches_swarm"] = swarm_counts.get(counter)
        r["launches_crew"] = crew_counts.get(counter)
        if r["name"] == "select_i4" and scale:
            r["other_shapes"] = r.get("other_shapes", []) + scale
    if notes:
        say(f"sharded and crew times: {json.dumps(notes)}")
    say(json.dumps({"kernels": results}))
    say(dev["smi"])
    if full:
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["name"],
            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
