"""WARC ingest: the node's own `index_cc` pipeline reads gzip WARC files
that set-up writes from the seed (`files` files of pages in the mix of
languages, text lengths and HTML sizes that the traffic file sets; see
texts.Pages), over a store seeded with `index_capacity × seeded_share`
pages. The window opens once the node inserts in steady state (see
`_ramp`), and closes as the first batch after `--seconds` lands;
`ingest_pages_s` is the rise of `pages_inserted` over the window. The
files hold `pages_per_s × (ramp_s + seconds)` pages that the node keeps
(English, with text enough), and the pages it drops among them; the run
fails if the source runs dry, the index regrows or the page cap is hit
inside the window."""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import time
import urllib.parse

import numpy as np

from benchmark import peaks, seeds, store, texts, warc, weights
from benchmark.window import Capture, Window

SEED_URL = "https://seed.example/"
NODE_BATCH = 512  # the node's ingest_batch_size unless the run sets it


PAGE_KEYS = ("languages", "text_mean_chars", "text_sigma",
             "html_mean_bytes", "html_sigma", "html_max_bytes")


def _corpus(seed: int, n: int, traffic: dict) -> texts.Pages:
    return texts.Pages(seed, n, **{k: traffic[k] for k in PAGE_KEYS})


def _page_count(run) -> tuple[int, int]:
    """(pages in the files, pages of them the node keeps): the least
    count whose kept pages reach pages_per_s × (ramp_s + seconds)."""
    tr = run.traffic
    need = int(tr["pages_per_s"] * (tr["ramp_s"] + run.seconds))
    seed = seeds.torch_seed(run.seed, seeds.PAGES)
    n = int(need / tr["languages"]["en"]) + 1
    while True:
        kept = int(_corpus(seed, n, tr).kept().sum())
        if kept >= need:
            return n, kept
        n = int(n * need / max(kept, 1)) + 16


def _write_file(args) -> int:
    seed, n, f, files, traffic, path = args
    pages = _corpus(seed, n, traffic)
    return warc.write(path, pages, range(f, n, files))


def prepare(run) -> dict:
    import torch
    dev = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    W = weights.make(cfg, seeds.torch_seed(run.seed, seeds.WEIGHTS), dev)
    written = weights.write_checkpoint(run.model_dir, cfg, W)
    del W
    n_seed = round(cfg["index_capacity"] * tr["seeded_share"])
    g = torch.Generator(device=dev).manual_seed(
        seeds.torch_seed(run.seed, seeds.STORE))
    rows = store.unit_rows(n_seed, cfg["hidden_size"], g, dev)
    written += store.write(run.data_dir, rows, lambda i: f"{SEED_URL}{i}",
                           lambda i: "", lambda i: f"seeded page {i}")
    del rows
    wdir = os.path.join(run.work, "warc")
    os.makedirs(wdir)
    (n, kept), files = _page_count(run), tr["files"]
    jobs = [(seeds.torch_seed(run.seed, seeds.PAGES), n, f, files, tr,
             os.path.join(wdir, f"CC-BENCH-{f:05d}.warc.gz"))
            for f in range(files)]
    t0 = time.monotonic()
    with cf.ProcessPoolExecutor(min(files, tr["writers"]),
                                mp_context=mp.get_context("spawn")) as ex:
        warc_bytes = sum(ex.map(_write_file, jobs))
    return {"bytes_written": written + warc_bytes, "warc_bytes": warc_bytes,
            "warc_s": time.monotonic() - t0, "files_pages": n,
            "pages": kept, "seeded": n_seed,
            "warc": os.path.join(wdir, "*.warc.gz")}


def node_settings(run) -> dict:
    return {"DAWNSEARCH_INDEX_CC": "true",
            "DAWNSEARCH_WARC_SOURCE": os.path.join(run.work, "warc",
                                                   "*.warc.gz"),
            "DAWNSEARCH_INGEST_WORKERS": str(run.config["ingest_workers"])}


def _ramp(run, node) -> dict:
    """Wait until the node inserts in steady state; return its metrics
    then. Pages that the extraction workers queued while the node
    started (and, in a checkout's first run, built its kernels) land
    first, in merged batches; the window opens as the
    first unmerged batch lands after `ramp_batches` batches, or
    `ramp_s` seconds after those, whichever comes first."""
    tr = run.traffic
    single = int(run.node_env.get("DAWNSEARCH_INGEST_BATCH_SIZE",
                                  NODE_BATCH))
    deadline = time.monotonic() + tr["ramp_timeout_s"]
    prev, since = None, None
    while True:
        m = node.get("/api/metrics")
        count = m.get("ingest_insert_count", 0)
        if count >= tr["ramp_batches"]:
            since = since or time.monotonic()
            if prev is not None and count == prev[0] + 1 and \
                    m.get("pages_inserted", 0) - prev[1] <= single:
                return m
            if time.monotonic() > since + tr["ramp_s"]:
                return m
            prev = (count, m.get("pages_inserted", 0))
        if time.monotonic() > deadline or node.proc.poll() is not None:
            raise RuntimeError(f"no {tr['ramp_batches']} insert batches in "
                               f"{tr['ramp_timeout_s']} s:\n{node.tail()}")
        time.sleep(0.02)


def run(run, node, manifest: dict, t_start: float) -> Window:
    tr = run.traffic
    m0 = _ramp(run, node)
    t0 = time.monotonic()
    s0 = node.get("/api/stats")
    cap = Capture(node, min(run.seconds, tr["trace_s"])) if run.trace \
        else None
    # pages_inserted each second, printed to show where a slow window
    # loses its pages
    series = []
    while time.monotonic() < t0 + run.seconds - 1.0:
        time.sleep(1.0)
        series.append(node.get("/api/metrics").get("pages_inserted", 0)
                      - m0.get("pages_inserted", 0))
    # the window ends where the first batch after t0 + seconds lands, so
    # it holds whole batches (each a few seconds' worth of pages)
    time.sleep(max(0.0, t0 + run.seconds - time.monotonic()))
    last = node.get("/api/metrics")["ingest_insert_count"]
    while True:
        m1 = node.get("/api/metrics")
        t1 = time.monotonic()
        if m1["ingest_insert_count"] > last or \
                t1 > t0 + run.seconds + tr["ramp_timeout_s"]:
            break
        time.sleep(0.02)
    s1 = node.get("/api/stats")
    w = Window(t0, t1, m0, m1, run.config)
    w.trace = cap.result() if cap else None
    inserted = w.delta("pages_inserted")
    left = manifest["pages"] - m1.get("pages_inserted", 0)
    problems = []
    if left < tr["min_left"]:
        problems.append(f"the source ran dry ({left} pages left)")
    if s0["index_capacity"] != s1["index_capacity"]:
        problems.append(f"the index regrew ({s0['index_capacity']} -> "
                        f"{s1['index_capacity']})")
    if s1["pages_indexed"] >= run.config["index_capacity"]:
        problems.append("the page cap was hit")
    if problems:
        raise RuntimeError("; ".join(problems))
    seeded = manifest["seeded"]
    first = seeded + m0.get("pages_inserted", 0) + 1
    last = seeded + m1.get("pages_inserted", 0)
    w.extra = {"first": first, "last": last}
    w.rows = s1["pages_indexed"]
    w.attempted = int(inserted)
    w.e2e = {"ingest_pages_s": inserted / w.seconds, "setup_s": t0 - t_start}
    w.extra["found"] = _found(run, node, first, last)
    if run.trace:
        w.flops = _flops(run, manifest, first, last)
    w.lines += [
        f"pages inserted since the window opened, each second: {series}",
        f"pages inserted in the window {int(inserted)} in {w.seconds:.3f} s; "
        f"index capacity {s1['index_capacity']}, {s1['pages_indexed']} "
        f"pages; {left} pages left in the files",
        f"setup_s {w.e2e['setup_s']!r} (prepare "
        f"{manifest['prepare_s']:.1f} s, of it WARC files "
        f"{manifest['warc_s']:.1f} s; {manifest['bytes_written']} bytes "
        f"written, of them WARC {manifest['warc_bytes']}; "
        f"{manifest['files_pages']} pages in the files, "
        f"{manifest['pages']} to keep)"]
    return w


def _sample(run, first: int, last: int, n: int) -> list[int]:
    rng = seeds.rng(run.seed, seeds.JUDGE)
    ids = np.arange(first, last + 1)
    return sorted(rng.choice(ids, min(n, len(ids)), replace=False).tolist())


def _found(run, node, first: int, last: int) -> list[tuple[str, str]]:
    """Search the node for sampled pages of the window by their own text:
    (url of the page, url of the first result)."""
    want = _sample(run, first, last, run.traffic["searched"])
    by_id = {r[0]: r for r in store.read_rows(run.data_dir, want,
                                              run.config["hidden_size"])}
    out = []
    for i in want:
        if i not in by_id:
            out.append(("missing", ""))
            continue
        _, url, title, text, _ = by_id[i]
        q = urllib.parse.quote(f"{title}\n{text}")
        res = node.get("/api/search?q=" + q)["results"]
        out.append((url, res[0]["url"] if res else ""))
    return out


def _flops(run, manifest: dict, first: int, last: int) -> float:
    pages = _corpus(seeds.torch_seed(run.seed, seeds.PAGES),
                    manifest["files_pages"], run.traffic)
    total = 0.0
    for url in store.read_urls(run.data_dir, first, last):
        i = texts.Pages.index_of(url)
        _, title, text = pages.stored(i)
        total += peaks.encoder_flops(texts.combined_tokens(title, text),
                                     run.config)
    return total


def judge(run, window, manifest: dict) -> dict:
    """Hold sampled pages of the window to the reference: each stored
    (url, title, text) to what the WARC file holds, and each a page the
    node should keep (`text_mismatch`: the parse, the extraction and the
    filters); the stored embedding to the reference's of the page's text
    (`emb_gap`, 1 - cosine: the tokenizer, the encoder and the pool); and
    each searched page at rank 1 (`not_found`: the i8 index write and its
    select)."""
    import torch

    from benchmark.reference import encoder
    from benchmark.reference.wordpiece import WordPiece
    dev = torch.device(run.device)
    cfg, lim = run.config, run.limits
    first, last = window.extra["first"], window.extra["last"]
    rows = store.read_rows(run.data_dir,
                           _sample(run, first, last, run.traffic["judged"]),
                           cfg["hidden_size"])
    pages = _corpus(seeds.torch_seed(run.seed, seeds.PAGES),
                    manifest["files_pages"], run.traffic)
    kept = pages.kept()
    mismatch, combined, stored = 0, [], []
    for _, url, title, text, emb in rows:
        try:
            i = texts.Pages.index_of(url)
            exp = pages.stored(i) if kept[i] else None
        except (ValueError, IndexError):
            exp = None
        if exp != (url, title, text):
            mismatch += 1
        combined.append(f"{title}\n{text}")
        stored.append(emb)
    W = weights.make(cfg, seeds.torch_seed(run.seed, seeds.WEIGHTS), dev)
    tok = WordPiece(texts.vocab_for(cfg))
    encoder.strict_f32()
    ref = encoder.embed(W, cfg, [tok.encode(c) for c in combined], dev,
                        tok.pad_id).cpu().numpy()
    got = np.stack(stored) if stored else np.zeros((0, cfg["hidden_size"]))
    cos = (got * ref).sum(1) / np.maximum(
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1), 1e-30)
    gap = float((1.0 - cos).max()) if len(cos) else float("inf")
    found = window.extra["found"]
    not_found = sum(a != b for a, b in found)
    window.lines.append(f"judged {len(rows)} pages of the window "
                        f"(ids {first}..{last}); searched {len(found)}")
    return {"emb_gap": {"value": gap, "limit": lim["emb_gap"]},
            "text_mismatch": {"value": mismatch, "limit": 0},
            "not_found": {"value": not_found, "limit": 0},
            "unjudged": {"value": max(0, lim["min_judged"] - len(rows)),
                         "limit": 0}}
