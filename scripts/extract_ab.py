#!/usr/bin/env python3
"""Time the stages of iter_pages, per WARC record, for one checkout of the
port, so that two checkouts can be compared on one host.

    python3 scripts/extract_ab.py --tree PATH --label NAME [--pages N] \
        [--seed S] [--passes R] [--out FILE.json]

PATH is the root of a checkout of this repository (by default the one
this script lies in). The script writes one gzip WARC file of N pages of
the cell mpnet-ingest's traffic (benchmark/traffic/warc-ingest.json,
through this script's benchmark/texts.py::Pages and benchmark/warc.py,
so that every checkout reads the same bytes), then runs the checkout's
ingest/pages.py::iter_pages over it once to build its native libraries
and warm up, and R times with a Stages. Each pass gives, per record, the
microseconds of each stage (read: inflate and parse; decode; html;
filter) and of their sum, the records read, the pages kept, the repaired
bodies where the checkout counts them, and the kept pages whose (url,
title, text) differ from what Pages says the node stores (`mismatch`,
which has to be 0). The line `median` holds each figure's median over the
passes. Compare two checkouts in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("read", "decode", "html", "filter")
PAGE_KEYS = ("languages", "text_mean_chars", "text_sigma", "html_mean_bytes",
             "html_sigma", "html_max_bytes")


def write_corpus(path: str, seed: int, n: int):
    """N pages of the warc-ingest traffic into one WARC file; returns the
    Pages that made them."""
    sys.path.insert(0, HERE)
    from benchmark import texts, warc
    with open(os.path.join(HERE, "benchmark", "traffic",
                           "warc-ingest.json")) as f:
        traffic = json.load(f)
    pages = texts.Pages(seed, n, **{k: traffic[k] for k in PAGE_KEYS})
    warc.write(path, pages, range(n))
    sys.path.remove(HERE)
    return pages


def one_pass(mod_pages, path: str, pages) -> dict:
    st = mod_pages.Stages()
    t0 = time.perf_counter()
    mismatch = 0
    for page in mod_pages.iter_pages(path, st):
        want = pages.stored(pages.index_of(page.url))
        mismatch += (page.url, page.title, page.text) != want
    wall = time.perf_counter() - t0
    n = max(st.records, 1)
    out = {f"{s}_us": 1e6 * getattr(st, s) / n for s in STAGES}
    out["total_us"] = sum(out[f"{s}_us"] for s in STAGES)
    out["wall_us"] = 1e6 * wall / n
    out.update(records=st.records, kept=st.kept, mismatch=mismatch,
               repaired=getattr(st, "repaired", None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--pages", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=4317000113)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pages.warc.gz")
        t0 = time.perf_counter()
        pages = write_corpus(path, args.seed, args.pages)
        print(f"{args.label}: wrote {args.pages} pages "
              f"({os.path.getsize(path)} bytes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        sys.path.insert(0, tree)
        from dawnsearch_tpu_torch.ingest import native
        from dawnsearch_tpu_torch.ingest import pages as mod_pages
        assert mod_pages.__file__.startswith(tree), mod_pages.__file__
        readers = native.readers()
        one_pass(mod_pages, path, pages)  # builds the libraries, warms up
        runs = []
        for r in range(args.passes):
            runs.append(one_pass(mod_pages, path, pages))
            print(json.dumps({"label": args.label, "pass": r, **runs[-1]}),
                  flush=True)
    median = {k: statistics.median(run[k] for run in runs)
              for k in runs[0] if runs[0][k] is not None}
    print(json.dumps({"label": args.label, "median": median,
                      "readers": readers}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"label": args.label, "tree": tree, "seed": args.seed,
                       "pages": args.pages, "readers": readers,
                       "passes": runs, "median": median}, f, indent=1)
    return 0 if all(run["mismatch"] == 0 for run in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
