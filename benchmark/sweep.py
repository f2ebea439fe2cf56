"""The knee sweep of an open-loop search cell: one node, then a window of
`--seconds` at each of `--rates`, each line giving the latency from due
(median, p95, p99), the failed requests, the generator's lateness, and
the backlog's trend (median latency of the window's last quarter minus
its first). The knee is the highest rate whose p95 stays under the limit
while the trend stays flat.

    python3 benchmark/sweep.py --workload minilm-search-steady --seed 1 \
        --rates 200,400,800 --seconds 10
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run as bench_run  # noqa: E402
from benchmark import stats  # noqa: E402
from benchmark.kinds import search_open  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=int, default=10)
    a = p.parse_args()
    rates = [float(r) for r in a.rates.split(",")]

    def drive(run, node, manifest, t_start):
        # a first window at the lowest rate, not reported: the node's
        # first queries load and build lazily
        search_open.drive(run, node, manifest, t_start, rates[0], a.seconds,
                          2.0)
        w = None
        for rate in rates:
            w = search_open.drive(run, node, manifest, t_start, rate,
                                  a.seconds, 2.0)
            due = sorted(w.records, key=lambda r: r[2])
            lat = [(r[4] - r[2]) * 1e3 if r[5] == 200 else float("inf")
                   for r in due]
            q = max(1, len(lat) // 4)
            trend = stats.percentile(lat[-q:], 50) - \
                stats.percentile(lat[:q], 50)
            late = [(r[3] - r[2]) * 1e3 for r in due]
            print(f"sweep rate {rate} /s: {len(due)} requests, failed "
                  f"{w.failed}, ms from due: median "
                  f"{stats.percentile(lat, 50):.2f} p95 "
                  f"{stats.percentile(lat, 95):.2f} p99 "
                  f"{stats.percentile(lat, 99):.2f}; backlog trend "
                  f"{trend:.2f} ms; lateness p99 "
                  f"{stats.percentile(late, 99):.2f} ms",
                  file=sys.stderr, flush=True)
        return w
    return bench_run.main(["--workload", a.workload, "--seed", str(a.seed),
                           "--seconds", str(a.seconds)], drive=drive)


if __name__ == "__main__":
    raise SystemExit(main())
