"""Open loop: independent searchers. `GET /api/search?q=` at Poisson
arrivals of a fixed `rate`, each query drawn by Zipf popularity
(`zipf_exponent`) from the pool, sent when due whatever is outstanding,
from `client_processes` processes. Warm-up: `warmup_s` of the same
traffic. `search_p95_ms` is the 95th percentile over every request due in
the window of completion minus due time, a request that never came
counting as infinite."""

from __future__ import annotations

import math
import multiprocessing as mp
import time

import numpy as np

from benchmark import client, searchload, seeds, stats
from benchmark.texts import poisson_due, zipf_ranks
from benchmark.window import Capture, Window

prepare = searchload.prepare
judge = searchload.judge


def node_settings(run) -> dict:
    return {}


def _schedule(run, qs: list[str], rate: float, warm: float,
              seconds: float):
    """(items, offsets from the start, keep) of the warm-up and the
    window, which opens `warm` s after the start. Every seed sends the
    same number of requests with the same gaps and the same popularity,
    in its own order."""
    tr = run.traffic
    n_w, n = round(rate * warm), round(rate * seconds)
    rng_w = seeds.rng(run.seed, seeds.WARMUP)
    rng = seeds.rng(run.seed, seeds.SCHEDULE)
    ranks = zipf_ranks(rng, n_w + n, len(qs), tr["zipf_exponent"])
    offsets = np.concatenate([poisson_due(rng_w, n_w, rate),
                              warm + poisson_due(rng, n, rate)])
    judged = set(seeds.rng(run.seed, seeds.JUDGE).choice(
        n, min(n, tr["judged"]), replace=False) + n_w)
    longest = {i for i in range(n_w, n_w + n)
               if len(qs[ranks[i]].split()) >= tr["long_words"]}
    judged |= set(sorted(longest)[:tr["judged"] // 4])
    items = [(i, int(ranks[i]), client.search_path(qs[ranks[i]]))
             for i in range(n_w + n)]
    keep = [i in judged for i in range(n_w + n)]
    return items, offsets, keep, n_w


def run(run, node, manifest: dict, t_start: float) -> Window:
    tr = run.traffic
    return drive(run, node, manifest, t_start, tr["rate"], run.seconds,
                 tr["warmup_s"])


def drive(run, node, manifest: dict, t_start: float, rate: float,
          seconds: float, warm: float) -> Window:
    """Warm-up, then a window of `seconds` at `rate` queries/s."""
    tr = run.traffic
    qs = searchload.queries(run)
    P = tr["client_processes"]
    items, offsets, keep, n_w = _schedule(run, qs, rate, warm, seconds)
    ctx = mp.get_context("spawn")
    out, ready = ctx.Queue(), ctx.Queue()
    start_qs = [ctx.Queue() for _ in range(P)]
    procs = [ctx.Process(target=client.open_loop, args=(
        node.port, items[p::P], list(offsets[p::P]), keep[p::P],
        tr["timeout_s"], tr["connections"] // P, ready, start_qs[p], out))
        for p in range(P)]
    t0 = client.start_workers(procs, ready, start_qs) + warm
    time.sleep(max(0.0, t0 - time.monotonic()))
    m0 = node.get("/api/metrics")
    cap = Capture(node, min(seconds, tr["trace_s"])) if run.trace \
        else None
    t1 = t0 + seconds
    time.sleep(max(0.0, t1 - time.monotonic()))
    m1 = node.get("/api/metrics")
    stats_ = node.get("/api/stats")
    records = []
    for _ in procs:
        records += out.get()
    for p in procs:
        p.join()
    w = Window(t0, t1, m0, m1, run.config)
    w.trace = cap.result() if cap else None
    w.rows = stats_["pages_indexed"]
    # every request due in the window; late answers count their wait
    due = [r for r in records if r[0] >= n_w]
    lat = [(r[4] - r[2]) * 1e3 if r[5] == 200 else math.inf for r in due]
    late = [(r[3] - r[2]) * 1e3 for r in due]
    w.records = due
    w.attempted, w.failed = len(due), sum(r[5] != 200 for r in due)
    w.e2e = {"search_p95_ms": stats.percentile(lat, 95),
             "setup_s": t0 - t_start}
    w.flops = searchload.flops(run, w, qs)
    w.lines += [
        f"requests due in the window {len(due)} at {rate} /s, failed "
        f"{w.failed}; latency from due, ms: median "
        f"{stats.percentile(lat, 50)!r} p95 {stats.percentile(lat, 95)!r} "
        f"p99 {stats.percentile(lat, 99)!r}",
        f"generator lateness, ms: median {stats.percentile(late, 50)!r} "
        f"p99 {stats.percentile(late, 99)!r} max {max(late, default=0)!r}",
        f"setup_s {w.e2e['setup_s']!r} (prepare "
        f"{manifest['prepare_s']:.1f} s, {manifest['bytes_written']} bytes "
        f"written)"]
    return w
