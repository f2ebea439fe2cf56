"""Closed loop: `clients` searchers, each sending its next query as soon
as its last answer came, queries drawn by Zipf popularity from the pool,
from `client_processes` processes. Warm-up: `warmup_s` of the same loop.
`search_qps` counts the searches answered with 200 and k results inside
the window, over the window."""

from __future__ import annotations

import multiprocessing as mp
import time

from benchmark import client, searchload, seeds, stats
from benchmark.texts import zipf_ranks
from benchmark.window import Capture, Window

prepare = searchload.prepare
judge = searchload.judge


def node_settings(run) -> dict:
    return {}


def run(run, node, manifest: dict, t_start: float) -> Window:
    tr = run.traffic
    qs = searchload.queries(run)
    P, k = tr["client_processes"], run.config["search_k"]
    per = tr["requests_per_process"]
    ranks = zipf_ranks(seeds.rng(run.seed, seeds.SCHEDULE), P * per, len(qs),
                       tr["zipf_exponent"])
    long_q = {q for q in range(len(qs))
              if len(qs[q].split()) >= tr["long_words"]}
    warm = tr["warmup_s"]
    ctx = mp.get_context("spawn")
    out, ready = ctx.Queue(), ctx.Queue()
    start_qs = [ctx.Queue() for _ in range(P)]
    procs = []
    for p in range(P):
        items = [(p + P * i, int(ranks[p + P * i]),
                  client.search_path(qs[ranks[p + P * i]]))
                 for i in range(per)]
        procs.append(ctx.Process(target=client.closed_loop, args=(
            node.port, items, tr["keep_every"], long_q, tr["clients"] // P,
            warm + run.seconds, tr["timeout_s"], ready, start_qs[p], out)))
    t0 = client.start_workers(procs, ready, start_qs) + warm
    t1 = t0 + run.seconds
    time.sleep(max(0.0, t0 - time.monotonic()))
    m0 = node.get("/api/metrics")
    cap = Capture(node, min(run.seconds, tr["trace_s"])) if run.trace \
        else None
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
    inside = [r for r in records if t0 <= r[4] <= t1]
    good = [r for r in inside if r[5] == 200 and r[6] == k]
    if len(records) >= P * per:
        raise RuntimeError("the clients ran out of queries: raise "
                           "requests_per_process")
    w.records = [r for r in records if r[3] >= t0 or r[4] >= t0]
    w.attempted = len(w.records)
    w.failed = sum(r[5] != 200 for r in w.records)
    lat = [(r[4] - r[3]) * 1e3 for r in good]
    w.e2e = {"search_qps": len(good) / run.seconds, "setup_s": t0 - t_start}
    w.flops = searchload.flops(run, w, qs)
    w.lines += [
        f"answered in the window {len(good)} of {len(inside)} completions "
        f"({tr['clients']} clients); failed {w.failed}; latency from send, "
        f"ms: median {stats.percentile(lat, 50)!r} p99 "
        f"{stats.percentile(lat, 99)!r}",
        f"setup_s {w.e2e['setup_s']!r} (prepare "
        f"{manifest['prepare_s']:.1f} s, {manifest['bytes_written']} bytes "
        f"written)"]
    return w
