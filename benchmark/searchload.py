"""What the two search kinds share: the queries, the store they search,
the judged sample and the comparison with the reference.

The store holds `index_capacity × store_share` pages. For every query of
the pool (`pool` distinct queries, `query_words` their lengths), the
reference's embedding of it anchors `planted_per_query` pages at a cosine
drawn from `planted_cos`, at seeded places; every other page is a random
unit vector. So a query's results spread over the store as distinct
queries' do."""

from __future__ import annotations

import json
import math
import os

import numpy as np

from benchmark import peaks, seeds, store, texts, weights
from benchmark.reference import encoder
from benchmark.reference.search import exact_topk
from benchmark.reference.wordpiece import WordPiece

PAGE_URL = "https://pages.example/"


def pool(run) -> list[str]:
    tr = run.traffic
    return texts.query_pool(seeds.rng(run.seed, seeds.QUERIES), tr["pool"],
                            tr["query_words"])


def _anchored_store(run, queries: list[str], dev):
    """(weights, reference embeddings of the queries, store rows)."""
    cfg, tr = run.config, run.traffic
    W = weights.make(cfg, seeds.torch_seed(run.seed, seeds.WEIGHTS), dev)
    tok = WordPiece(texts.vocab_for(cfg))
    encoder.strict_f32()
    anchors = encoder.embed(W, cfg, [tok.encode(q) for q in queries], dev,
                            tok.pad_id)
    n = round(cfg["index_capacity"] * tr["store_share"])
    lo, hi = tr["planted_cos"]
    rows = store.planted(n, anchors, tr["planted_per_query"], lo, hi,
                         seeds.torch_seed(run.seed, seeds.STORE), dev)
    return W, anchors, rows


def prepare(run) -> dict:
    import torch
    dev = torch.device(run.device)
    queries = pool(run)
    W, _, rows = _anchored_store(run, queries, dev)
    written = weights.write_checkpoint(run.model_dir, run.config, W)
    written += store.write(run.data_dir, rows, lambda i: f"{PAGE_URL}{i}",
                           lambda i: "", lambda i: f"page {i} of the store")
    with open(os.path.join(run.work, "queries.json"), "w") as f:
        json.dump(queries, f)
    return {"bytes_written": written, "pages": rows.shape[0]}


def queries(run) -> list[str]:
    with open(os.path.join(run.work, "queries.json")) as f:
        return json.load(f)


def flops(run, window, qs: list[str]) -> float:
    """Model operations of the queries answered in the window."""
    tokens = {}
    total = 0.0
    for r in window.records:
        if r[5] == 200 and window.t0 <= r[4] <= window.t1:
            q = r[1]
            if q not in tokens:
                tokens[q] = peaks.encoder_flops(
                    texts.token_count(qs[q]) + 2, run.config)
            total += tokens[q]
    return total


def judge(run, window, manifest: dict) -> dict:
    """Hold every kept answer of the window to the reference: the gap
    between each served distance and the reference's distance of the page
    served (`score_gap`: the tokenizer, the encoder, the re-rank and the
    join). How far the r-th result served lies below the reference's r-th
    best (`rank_gap`: K2's fold and top-k) is printed, not compared.
    Answers short of k results, or that never came, fail exactly."""
    import torch
    dev = torch.device(run.device)
    qs = queries(run)
    k = run.config["search_k"]
    kept = [r for r in window.records if r[8] is not None]
    _, anchors, rows = _anchored_store(run, qs, dev)
    n = rows.shape[0]
    qidx = sorted({r[1] for r in kept})
    where = {q: j for j, q in enumerate(qidx)}
    qref = anchors[torch.tensor(qidx, device=dev)]
    ref_d, _ = exact_topk(rows, qref, k)
    ref_d = ref_d.cpu().numpy()
    score_gap = rank_gap = 0.0
    short = 0
    for r in kept:
        served = r[8]
        if len(served) < k:
            short += 1
        ids = []
        for url, _ in served:
            i = int(url[len(PAGE_URL):]) if url.startswith(PAGE_URL) and \
                url[len(PAGE_URL):].isdigit() else -1
            ids.append(i if 0 <= i < n else -1)
        if min(ids, default=0) < 0:
            score_gap = math.inf
            continue
        j = where[r[1]]
        got = 1.0 - (rows[torch.tensor(ids, device=dev)]
                     @ qref[j]).cpu().numpy()
        dist = np.array([d for _, d in served])
        score_gap = max(score_gap, float(np.abs(dist - got).max()))
        rank_gap = max(rank_gap, float((got - ref_d[j, :len(got)]).max()))
    lim = run.limits
    window.lines.append(f"judged {len(kept)} answers of {len(qidx)} queries; "
                        f"{short} short of {k} results")
    # not compared: K2's fold drops candidates by design, as far in sound
    # runs as in the control's (PERF.md); recorded on every run
    window.lines.append(f"reading rank_gap {rank_gap!r} (not compared)")
    return {"score_gap": {"value": score_gap, "limit": lim["score_gap"]},
            "short_answers": {"value": short, "limit": 0},
            "failed": {"value": window.failed, "limit": 0},
            "unjudged": {"value": max(0, lim["min_judged"] - len(kept)),
                         "limit": 0}}
