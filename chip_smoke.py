#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (dawnsearch_tpu_torch) once on one GPU.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases build,k1,k2
    python3 chip_smoke.py --phases k3,k2bf16,recall_i4,i4_scale

Phases, each printing one progress line; any failure exits non-zero:
  device    card name and power limit (nvidia-smi); fails without CUDA
  build     nvcc builds csrc/*.cu into dawnsearch_tpu_torch/_build/ (one
            nvcc per source, in parallel) and prints ptxas' registers
  k1        whole-layer kernel vs bert_layer_plain at MiniLM width, bf16,
            (B=64, S=128), (B=8, S=512) and (B=64, S=16: short queries)
            with ragged masks; timed, beside torch's TransformerEncoderLayer
            fast path on the same weights (the library yardstick)
  k2        i8 score+select vs select_candidates_plain at 1,048,576 x 384
            codes and 1024 queries: values and ids bit-equal; timed
  k3        i4 score+select (K3) at 1,048,576 logical rows (201 MB packed)
            and 1024 queries: qi8 values and ids bit-equal to the plain
            twin, qi8=False within the bf16 tolerance; timed
  k2bf16    K2 over bf16 codes (805 MB) and K2 i8 with qi8=False, 1024
            queries, within the bf16 tolerance; timed
  recall    FlatIndex i8 at 1,048,576 seeded unit rows, 1024 queries,
            recall@10 raw and after the f32 re-rank of k+30 candidates
  recall_i4 FlatIndex i4 at 2,097,152 rows built through host-packed adds
            (re-rank at the i4 ladder's 256 candidates) and FlatIndex
            bf16 at 1,048,576 rows (k+30)
  i4_scale  a 67,108,864-row i4 index (12.9 GB of codes) filled by device
            adds, searched at B=1 and B=1024, a planted row at rank 1
  profile   where a text query's time goes on the node's default path
            (FusedQueryPath over 270,000 i8 rows): host-timed tokenize,
            encode, select and whole query at B=1, 8, 64, and the device
            busy share and top kernels from torch.profiler
  node      `python -m dawnsearch_tpu_torch` over a 270,000-page store
            (past the 262,144-row gate of the fused select), once each
            with index_dtype i8, i4 and bf16: 32 pages through
            /api/insert, 8 of them queried back through /api/search at
            rank 1, the K1 counter and the tier's select counter read from
            /api/metrics

The last two lines of a full run are a JSON line of per-kernel results
and {"ok": true, "device": {...}}. Times are CUDA-event medians of 10
runs after 3 warm-ups. Each kernel's bound_ms is the larger of its
operations over the H100's dense peak for their type and its bytes (each
input read once, each output written once) over 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "k1", "k2", "k3", "k2bf16", "recall",
          "recall_i4", "i4_scale", "profile", "node")
K1_SHAPES = ((64, 128), (8, 512), (64, 16))
K2_ROWS, K2_BATCH = 1 << 20, 1024
I4_RECALL_ROWS = 1 << 21
I4_SCALE_ROWS, I4_SCALE_ADD = 1 << 26, 1 << 20
NODE_PAGES = 270_000
NODE_TIERS = ("i8", "i4", "bf16")
PROFILE_BATCHES, PROFILE_K = (1, 8, 64), 50
COS_MIN = 0.999          # bf16 bound of the reference (test_pallas_kernels.py)
RAW_RECALL_MIN, RERANK_RECALL_MIN = 0.95, 0.99
# bf16-query select variants vs their plain twin: f32 sums of the same
# bf16 products in another order differ by a few ulps of the dot, which
# can move a truncated key by one step (128 ulps: 1.5e-5 in [1, 2),
# 3.1e-5 in [2, 4)). Bound: two key steps on the values, the window ids
# equal on at least 99% of (query, window) pairs, and the top-10 after
# the fold to k + 30 and an f32 re-rank equal for every query.
BF16_VAL_TOL, BF16_ID_SHARE = 3.1e-5, 0.99
# H100 SXM dense peaks (NVIDIA data sheet, 700 W) and HBM3 bandwidth
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# each kernel entry's launch counter in /api/metrics
COUNTER = {"bert_layer": "kernel_bert_layer", "select_i8": "kernel_select",
           "select_i8_qbf16": "kernel_select_i8_qbf16",
           "select_bf16": "kernel_select_bf16",
           "select_i4": "kernel_select_i4",
           "select_i4_qbf16": "kernel_select_i4_qbf16"}
# select launch counters (ops/scan_select.VARIANTS) by node tier
NODE_SELECT = {"i8": "kernel_select", "i4": "kernel_select_i4",
               "bf16": "kernel_select_bf16"}

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
    dense peak for their type and bytes over the HBM bandwidth."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _layer_weights(rng: np.random.Generator, H: int, I: int, dev) -> list:
    """Seeded weights of one layer at width H, FFN I: bf16 matrices and
    non-trivial f32 biases and LayerNorm parameters."""
    def mat(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.05
                                ).to(dev, torch.bfloat16)

    def vec(n, base=0.0):
        return torch.from_numpy(base + rng.standard_normal(n, np.float32) * 0.1
                                ).to(dev)
    return [mat(H, 3 * H), vec(3 * H), mat(H, H), vec(H), vec(H, 1.0), vec(H),
            mat(H, I), vec(I), mat(I, H), vec(H), vec(H, 1.0), vec(H)]


def library_layer(weights: list, H: int, I: int, nh: int):
    """torch's TransformerEncoderLayer (post-LN, erf GELU) in bf16 with the
    K1 weights: the one PyTorch call that computes the same layer. It is
    K1's library yardstick only; the port never calls it."""
    wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = weights
    lay = torch.nn.TransformerEncoderLayer(
        H, nh, I, dropout=0.0, activation="gelu", layer_norm_eps=1e-12,
        batch_first=True, device=wqkv.device, dtype=torch.bfloat16).eval()
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


def k1_bound(B: int, S: int, H: int, I: int, x, weights) -> dict:
    """Projections 2·M·(4H² + 2HI) plus attention 4·B·S²·H at the bf16
    peak; bytes: x, y, the weights and the (B, S) key bias."""
    flops = 2 * B * S * (4 * H * H + 2 * H * I) + 4 * B * S * S * H
    return bound(flops, "bf16", 2 * nbytes(x) + nbytes(*weights) + B * S * 4)


def phase_k1(results: list) -> None:
    from dawnsearch_tpu_torch.ops import layer
    rng = np.random.default_rng(1)
    H, I, nh = 384, 1536, 12
    dev = torch.device("cuda")
    weights = _layer_weights(rng, H, I, dev)
    lib = library_layer(weights, H, I, nh)
    shapes = []
    for B, S in K1_SHAPES:
        x = torch.from_numpy(rng.standard_normal((B, S, H), np.float32)
                             ).to(dev, torch.bfloat16)
        lengths = rng.integers(S // 8, S + 1, B)
        lengths[0] = S
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
        bias = torch.where(mask, 0.0, -1e30).float()
        got = layer.fused_bert_layer(x, bias, *weights, nh=nh).float()
        want = layer.bert_layer_plain(x, bias, *weights, nh=nh).float()
        torch.cuda.synchronize()
        err = float((got - want)[mask].abs().max())
        cos = torch.nn.functional.cosine_similarity(got[mask], want[mask], dim=-1)
        m = mask[..., None].float()
        pooled = torch.nn.functional.cosine_similarity(
            (got * m).sum(1), (want * m).sum(1), dim=-1)
        ok = bool(torch.isfinite(got).all()) and float(cos.min()) > COS_MIN \
            and float(pooled.min()) > COS_MIN
        with torch.inference_mode():
            lib_out = lib(x, src_key_padding_mask=~mask).float()
            lib_cos = float(torch.nn.functional.cosine_similarity(
                lib_out[mask], want[mask], dim=-1).min())
            library_ms = cuda_ms(lambda: lib(x, src_key_padding_mask=~mask))
        ms = cuda_ms(lambda: layer.fused_bert_layer(x, bias, *weights, nh=nh))
        plain_ms = cuda_ms(lambda: layer.bert_layer_plain(x, bias, *weights,
                                                          nh=nh))
        bd = k1_bound(B, S, H, I, x, weights)
        say(f"phase k1 B={B} S={S}: max|d|={err:.3e} min token cos="
            f"{float(cos.min()):.6f} min pooled cos={float(pooled.min()):.6f}"
            f" kernel {ms:.3f} ms plain {plain_ms:.3f} ms library "
            f"{library_ms:.3f} ms (min token cos vs plain {lib_cos:.4f}) "
            f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"B={B} S={S} (cos bound {COS_MIN})")
        if lib_cos < 0.99:
            raise AssertionError(f"the library layer computes another "
                                 f"function (token cos {lib_cos:.4f})")
        shapes.append({"shape": f"B={B} S={S} H={H} I={I} bf16",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       **bd, "library_ms": library_ms})
    # the entry's numbers are the first (serving-batch) shape's; the
    # others ride along
    results.append({"name": "bert_layer", "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/layer.cu",
                    "replaces": "dawnsearch_tpu/ops/layer.py:275",
                    **shapes[0], "other_shapes": shapes[1:]})


def phase_k2(results: list) -> None:
    from dawnsearch_tpu_torch.index.flat import quantize_rows_i8
    from dawnsearch_tpu_torch.ops import scan_select as ss
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = _unit_rows(K2_ROWS, g, dev)
    queries = _unit_rows(K2_BATCH, g, dev)
    codes, scales = quantize_rows_i8(rows)
    qq, qs = ss.quantize_queries(queries)
    count = K2_ROWS - 1000  # the count mask bites in the last tile
    check_select(results, "k2", "select_i8",
                 "dawnsearch_tpu/ops/scan_select.py:281",
                 f"N={K2_ROWS} D=384 B={K2_BATCH} i8", qq, qs, codes, scales,
                 count, rows, queries)


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


def check_select(results: list, phase: str, name: str, replaces: str,
                 shape: str, q, qs, codes, scales, count: int, rows,
                 queries) -> None:
    """One select variant vs its plain twin on the same inputs: bit-equal
    for i8 queries, within the bf16 tolerance otherwise; both timed."""
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
    ms = cuda_ms(lambda: ss.select_candidates(q, qs, codes, scales, count))
    plain_ms = cuda_ms(lambda: ss.select_candidates_plain(q, qs, codes,
                                                          scales, count))
    bd = select_bound(q, qs, codes, scales, count)
    say(f"phase {phase} {name} {shape}: {agree}; kernel {ms:.3f} ms plain "
        f"{plain_ms:.3f} ms bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    results.append({"name": name, "route": "cuda",
                    "source": "dawnsearch_tpu_torch/csrc/scan_select.cu",
                    "replaces": replaces, "shape": shape,
                    "max_abs_err": err, "ids_equal_share": share, "ms": ms,
                    "plain_ms": plain_ms, **bd, "library_ms": None})


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
    qq, qs = ss.quantize_queries(queries)
    shape = f"N={K2_ROWS} D=384 B={K2_BATCH} i4"
    check_select(results, "k3", "select_i4",
                 "dawnsearch_tpu/ops/scan_select.py:221", shape, qq, qs,
                 codes, scales, count, rows, queries)
    check_select(results, "k3", "select_i4_qbf16",
                 "dawnsearch_tpu/ops/scan_select.py:221", shape + " qi8=False",
                 queries.bfloat16(), None, codes, scales, count, rows, queries)


def phase_k2bf16(results: list) -> None:
    from dawnsearch_tpu_torch.index.flat import quantize_rows_i8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    rows = _unit_rows(K2_ROWS, g, dev)
    queries = _unit_rows(K2_BATCH, g, dev)
    count = K2_ROWS - 1000
    qb = queries.bfloat16()
    check_select(results, "k2bf16", "select_bf16",
                 "dawnsearch_tpu/ops/scan_select.py:281",
                 f"N={K2_ROWS} D=384 B={K2_BATCH} bf16", qb, None,
                 rows.bfloat16(), None, count, rows, queries)
    codes, scales = quantize_rows_i8(rows)
    check_select(results, "k2bf16", "select_i8_qbf16",
                 "dawnsearch_tpu/ops/scan_select.py:281",
                 f"N={K2_ROWS} D=384 B={K2_BATCH} i8 qi8=False", qb, None,
                 codes, scales, count, rows, queries)


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
    the device busy share and the top kernels from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dawnsearch_tpu_torch.config import Config
    from dawnsearch_tpu_torch.node import make_encoder, make_index_factory
    from dawnsearch_tpu_torch.ops import scan_select as ss
    from dawnsearch_tpu_torch.serving.fused import FusedQueryPath, _encode
    dev = torch.device("cuda")
    cfg = Config()
    enc = make_encoder(cfg)
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
        ids, mask = enc.pad_batch(enc.tokenize_texts(texts))
        emb = _encode(enc, ids, mask)

        def query():
            emb, d, i, k_eff = path.dispatch(texts, PROFILE_K)
            return path.finalize(emb, d, i, B, PROFILE_K, k_eff)
        _, dists, _ = query()
        if not np.isfinite(dists).all():
            raise AssertionError(f"non-finite distances at B={B}")
        t = {"query": _host_ms(query),
             "tokenize": _host_ms(lambda: enc.pad_batch(
                 enc.tokenize_texts(texts))),
             "encode": _host_ms(lambda: _encode(enc, ids, mask)),
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


def seed_store(data_dir: str, n: int, seed: int = 4) -> None:
    """A page store of n synthetic pages: seeded unit embeddings, ids
    contiguous from 1."""
    from dawnsearch_tpu_torch.index.provider import DB_FILE
    from dawnsearch_tpu_torch.index.store import PageStore
    rng = np.random.default_rng(seed)
    store = PageStore(os.path.join(data_dir, DB_FILE))
    try:
        for s in range(0, n, 16384):
            e = rng.standard_normal((min(16384, n - s), 384), np.float32)
            e /= np.linalg.norm(e, axis=1, keepdims=True)
            store.insert_batch([(f"https://synthetic.example/{s + j}", "",
                                 f"synthetic page {s + j}", v)
                                for j, v in enumerate(e)])
    finally:
        store.close()


def run_nodes(n_pages: int, tiers=NODE_TIERS) -> dict:
    """Seed one store, then run the node once per index tier on a copy of
    it (a copy holds no index snapshot, so each tier builds its own
    index). Returns every kernel counter's increase, summed over runs."""
    work = tempfile.mkdtemp(prefix="dawn-node-")
    try:
        seed = os.path.join(work, "seed")
        os.makedirs(seed)
        t0 = time.perf_counter()
        seed_store(seed, n_pages)
        say(f"phase node: seeded {n_pages} pages in "
            f"{time.perf_counter() - t0:.1f} s")
        total: dict = {}
        for tier in tiers:
            data_dir = os.path.join(work, tier)
            shutil.copytree(seed, data_dir)
            for name, n in run_node(data_dir, tier).items():
                total[name] = total.get(name, 0) + n
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_node(data_dir: str, tier: str, start_timeout: float = 600.0) -> dict:
    """Start the node as a user would on `data_dir` with index_dtype
    `tier`, insert, query, read the kernel counters, stop. Returns the
    counters' increase; fails unless K1 and the tier's select ran."""
    from dawnsearch_tpu_torch.ops.scan_select import VARIANTS
    work = os.path.dirname(data_dir)
    t0 = time.perf_counter()
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, DAWNSEARCH_ACCEPT_INSERT="true", PYTHONPATH=HERE,
               DAWNSEARCH_INDEX_DTYPE=tier)
    log_path = os.path.join(work, f"node-{tier}.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dawnsearch_tpu_torch", "--config",
         os.path.join(work, "absent.toml"), "--web", "--data-dir", data_dir,
         "--listen", f"127.0.0.1:{port}"],
        cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + start_timeout
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"node exited with {proc.returncode}")
            try:
                stats = _http(base + "/api/stats", timeout=5)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(1.0)
        say(f"phase node {tier}: up in {time.perf_counter() - t0:.1f} s, "
            f"{stats['pages_indexed']} pages, capacity {stats['index_capacity']}")
        names = ("kernel_bert_layer", *VARIANTS.values())
        before = _http(base + "/api/metrics")
        if any(before.get(n, 0) for n in names):
            raise AssertionError(f"kernel counters not zero at start: {before}")
        pages = [{"url": f"https://pages.example/{j}", "title": "", "text": t}
                 for j, t in enumerate(TEXTS)]
        ins = _http(base + "/api/insert", {"pages": pages})
        if len(ins["inserted"]) != len(TEXTS):
            raise AssertionError(f"insert: {ins}")
        for j in QUERIED:
            res = _http(base + "/api/search?q=" + urllib.parse.quote(TEXTS[j]))
            top = res["results"]
            dists = [round(r["distance"], 5) for r in top[:3]]
            say(f"phase node {tier}: query {j} -> {top[0]['url']} top-3 distances "
                f"{dists} ({res['seconds']} s)")
            if top[0]["url"] != pages[j]["url"]:
                raise AssertionError(f"page {j} not at rank 1: {top[:3]}")
        after = _http(base + "/api/metrics")
        counts = {n: after.get(n, 0) - before.get(n, 0) for n in names}
        say(f"phase node {tier}: kernel launches {counts}")
        if not (counts["kernel_bert_layer"] and counts[NODE_SELECT[tier]]):
            raise AssertionError(f"a kernel of the path never ran: {counts}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        if rc != 0:
            raise RuntimeError(f"node exit code {rc} after SIGTERM")
        say(f"phase node {tier}: stopped cleanly in "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    full = set(phases) == set(PHASES)

    dev = phase_device()  # always: nothing runs without a GPU
    sys.path.insert(0, HERE)
    import dawnsearch_tpu_torch  # noqa: F401  (fails outside a checkout)
    results: list = []
    if set(phases) & {"build", "k1", "k2", "k3", "k2bf16"}:
        phase_build()
    scale: list = []
    for name, run in (("k1", lambda: phase_k1(results)),
                      ("k2", lambda: phase_k2(results)),
                      ("k3", lambda: phase_k3(results)),
                      ("k2bf16", lambda: phase_k2bf16(results)),
                      ("recall", phase_recall),
                      ("recall_i4", phase_recall_i4),
                      ("i4_scale", lambda: phase_i4_scale(scale)),
                      ("profile", phase_profile)):
        if name in phases:
            run()
            torch.cuda.empty_cache()
    # launches are counted only in the nodes' runs of the main path; a
    # partial run without them has no such count
    counts = run_nodes(NODE_PAGES) if "node" in phases else {}
    for r in results:
        r["launches"] = counts.get(COUNTER[r["name"]])
        if r["name"] == "select_i4" and scale:
            r["other_shapes"] = scale
    say(json.dumps({"kernels": results}))
    say(dev["smi"])
    if full:
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["name"],
            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
