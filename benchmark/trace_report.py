"""Summarise an /api/profile Chrome trace of the port's node.

    python3 benchmark/trace_report.py TRACE.json [--gaps 10] [--out REPORT.json]

Prints, and writes as JSON with --out:

- the file's size and the program's spans (category "dawn": "X" events,
  and the waits, which the port writes as async "b"/"e" pairs so that
  they name no gap) a second, by thread;
- each thread's share of time inside its top-level spans, between its
  first span's start and its last span's end;
- the longest device-idle gaps, each with the name that
  benchmark/trace.py gives it and what every thread was in meanwhile
  (the spans and waits that overlap the gap most, with the share they
  cover);
- the clock check: for each whole `encoder.forward` span (every launch
  in it has its kernel in the trace) whose sub-batch's `ingest.readback`
  is in the trace too, whether every kernel it launched starts after the
  span starts and ends before that readback ends.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.program_readers import launches, span_kernels  # noqa: E402
from benchmark.trace import Trace, load  # noqa: E402

ROLES = (("ingest.insert.wait", "insert"), ("ingest.tokenize.wait", "tokenize"),
         ("extract.collect.wait", "collect"), ("extract.record", "worker"),
         ("query.dispatch", "query"))


def _role(names: Counter, pid: int) -> str:
    for name, role in ROLES:
        if name in names:
            return f"{role} {pid}" if role == "worker" else role
    return names.most_common(1)[0][0]


def _overlap(e: dict, s: float, f: float) -> float:
    return max(0.0, min(e["ts"] + e["dur"], f) - max(e["ts"], s))


def waits(events: list[dict]) -> list[dict]:
    """The program's waits, each "b"/"e" pair as one span with a dur."""
    begun = {(e.get("pid"), e.get("id")): e for e in events
             if e.get("ph") == "b" and e.get("cat") == "dawn"}
    out = []
    for e in events:
        b = begun.get((e.get("pid"), e.get("id"))) \
            if e.get("ph") == "e" and e.get("cat") == "dawn" else None
        if b is not None:
            out.append({**b, "ph": "X", "dur": e["ts"] - b["ts"]})
    return out


def report(path: str, gaps: int = 10) -> dict:
    events = load(path)
    prof = [e for e in events if e.get("ph") == "X"
            and e.get("name", "").startswith("PyTorch Profiler")]
    seconds = prof[0]["dur"] / 1e6 if prof else None
    trace = Trace(events, seconds or 0.0)
    dawn = [e for e in trace.host if e.get("cat") == "dawn"] \
        + waits(events)
    by_thread: dict = defaultdict(list)
    for e in dawn:
        by_thread[(e["pid"], e["tid"])].append(e)
    roles = {k: _role(Counter(e["name"] for e in v), k[0])
             for k, v in by_thread.items()}
    threads = {}
    for key, spans in by_thread.items():
        top = sorted((e for e in spans if e["args"].get("parent_id") is None),
                     key=lambda e: e["ts"])
        covered, end = 0.0, top[0]["ts"] if top else 0.0
        for e in top:
            s, f = max(e["ts"], end), e["ts"] + e["dur"]
            if f > s:
                covered += f - s
                end = f
        span_us = end - top[0]["ts"] if top else 0.0
        threads[roles[key]] = {
            "pid": key[0], "tid": key[1], "spans": len(spans),
            "spans_per_s": len(spans) / seconds if seconds else None,
            "top_level_cover": covered / span_us if span_us else None,
            "by_name": dict(Counter(e["name"] for e in spans))}
    named = trace.idle_gaps(gaps)
    b = trace.busy_intervals
    longest = sorted(((s2 - e1, e1, s2) for (_, e1), (s2, _)
                      in zip(b, b[1:])), reverse=True)[:gaps]
    gap_rows = []
    for (name, length), (_, s, f) in zip(named, longest):
        row = {"seconds": length, "named": name, "threads": {}}
        for key, spans in by_thread.items():
            over: dict = defaultdict(float)
            for e in spans:
                o = _overlap(e, s, f)
                if o > 0:
                    label = e["name"] if e["args"].get("parent_id") is None \
                        else f"{e['args'].get('parent')} > {e['name']}"
                    over[label] += o
            row["threads"][roles[key]] = {
                k: round(v / (f - s), 3) for k, v in sorted(
                    over.items(), key=lambda kv: -kv[1])[:3]}
        gap_rows.append(row)
    calls, kernels = launches(trace)
    ids = {e["args"]["span_id"]: e for e in dawn}
    readbacks = defaultdict(list)
    for e in dawn:
        if e["name"] == "ingest.readback":
            readbacks[(e["pid"], e["tid"])].append(e)
    whole = checked = held = 0
    for e in dawn:
        if e["name"] != "encoder.forward":
            continue
        ks = span_kernels(e, calls, kernels)
        if not ks:
            continue
        whole += 1
        parent = ids.get(e["args"].get("parent_id"))
        if parent is None or "part" not in parent["args"]:
            continue
        rb = [r for r in readbacks[(e["pid"], e["tid"])]
              if r["ts"] >= e["ts"] + e["dur"]
              and r["args"].get("part") == parent["args"]["part"]
              and r["args"].get("batches") == e["args"].get("batches")]
        if not rb:
            continue
        rb = min(rb, key=lambda r: r["ts"])
        checked += 1
        if min(k["ts"] for k in ks) >= e["ts"] and \
                max(k["ts"] + k["dur"] for k in ks) <= rb["ts"] + rb["dur"]:
            held += 1
    return {"file_bytes": os.path.getsize(path), "capture_s": seconds,
            "dawn_spans": len(dawn), "device_busy_s": trace.busy_s,
            "threads": threads, "gaps": gap_rows,
            "clock_check": {"whole_spans": whole, "checked": checked,
                            "held": held}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace")
    p.add_argument("--gaps", type=int, default=10)
    p.add_argument("--out")
    args = p.parse_args(argv)
    out = report(args.trace, args.gaps)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
