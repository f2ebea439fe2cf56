"""WARC ingest of whole long pages by an LLM-based embedder (Qwen3).

warc_ingest_long's cell (its LongPages, WARC files, ramp and window, by
import), with what Qwen3-Embedding changes:

- the checkpoint is Qwen3's (HF tensor names), written in BF16 a tensor
  at a time, each tensor from its own seed (qwen3_work.tensor), so that
  the judge makes a layer's weights again alone: 15 GB never sits in the
  host's memory whole;
- the tokenizer.json has Qwen3's layout (NFC, a Split on Qwen2's pattern,
  ByteLevel without its regex, `$A <|endoftext|>`) at the published size,
  with merges that make a space and each word one token, so a page's
  tokens are known without a BPE pass (qwen3_work.page_tokens);
- the judge tokenizes with reference/bpe_qwen.py and embeds with
  reference/qwen3.py a layer at a time; the searched pages, each by its
  title and first `query_chars` of text under the query prompt, are
  drawn from all of the window's pages.
"""

from __future__ import annotations

import json
import os
import struct
import time
import urllib.parse

import numpy as np

from benchmark import qwen3_readers, qwen3_work, seeds, store, texts
from benchmark.kinds import warc_ingest_long as long
from benchmark.kinds.warc_ingest import SEED_URL, _ramp
from benchmark.window import Capture, Window

PAGE_KEYS = long.PAGE_KEYS
EOS = 151643  # <|endoftext|>
SPECIALS = {"<|endoftext|>": EOS, "<|im_start|>": EOS + 1,
            "<|im_end|>": EOS + 2}
# Qwen2's Split pattern, as Qwen3's tokenizer.json writes it
QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def tokenizer_json(vocab_size: int) -> dict:
    """A `tokenizers` file of Qwen3's layout at the published size: 256
    byte tokens, merges that make a space and each word of words.txt (and
    the stopwords) one token, a letter at a time, filler up to
    <|endoftext|> (151,643), <|im_start|> and <|im_end|> after it and
    filler to vocab_size; the NFC normalizer, a Split on Qwen2's pattern
    (isolated) and ByteLevel without its regex, `$A <|endoftext|>`."""
    from benchmark.reference.bpe import byte_to_unicode
    b2u = byte_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    sp = b2u[ord(" ")]
    for w in texts.STOPWORDS + tuple(texts.words()):
        prev = sp
        for ch in w:
            cur = prev + ch
            if cur not in vocab:
                merges.append([prev, ch])
                vocab[cur] = len(vocab)
            prev = cur
    if len(vocab) > EOS:
        raise ValueError(f"{len(vocab)} tokens do not fit below {EOS}")
    for k in range(len(vocab), EOS):
        vocab[f"<|filler_{k}|>"] = k
    added = dict(SPECIALS)
    for k in range(EOS + len(SPECIALS), vocab_size):
        added[f"<|reserved_{k - EOS}|>"] = k
    special = {"id": "<|endoftext|>", "type_id": 0}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for c, i in added.items()],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": False, "use_regex": False}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": special}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": special}],
            "special_tokens": {"<|endoftext|>": {
                "id": "<|endoftext|>", "ids": [EOS],
                "tokens": ["<|endoftext|>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": False,
                    "trim_offsets": False, "use_regex": False},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges}}


def vocab_words() -> frozenset:
    """The words the synthetic tokenizer makes one piece after a space,
    and every prefix of them."""
    out = set()
    for w in texts.STOPWORDS + tuple(texts.words()):
        for k in range(1, len(w) + 1):
            out.add(w[:k])
    return frozenset(out)


# -- the checkpoint ---------------------------------------------------------

def write_checkpoint(model_dir: str, config: dict, seed: int, device) -> int:
    """config.json, tokenizer.json and model.safetensors (BF16, HF names,
    each tensor made on `device` and written before the next is made);
    returns the bytes written."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config["published"], f, indent=2)
    with open(os.path.join(model_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(tokenizer_json(config["vocab_size"]), f,
                  ensure_ascii=False)
    header, offset = {}, 0
    shapes = qwen3_work.shapes(config)
    for name, shape in shapes.items():
        n = 2 * int(np.prod(shape))
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    import torch
    with open(os.path.join(model_dir, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, shape in shapes.items():
            t = qwen3_work.tensor(name, shape, seed, device)
            f.write(t.view(torch.int16).cpu().numpy().tobytes())
    return 8 + len(blob) + offset


def weights(config: dict, seed: int, device):
    """names -> {name: bf16 tensor on device}, the checkpoint's values."""
    shapes = qwen3_work.shapes(config)

    def make(names):
        return {n: qwen3_work.tensor(n, shapes[n], seed, device)
                for n in names}
    return make


# -- set-up, window, judge ----------------------------------------------------

def _page_count(run) -> tuple[int, int]:
    """(pages in the files, pages the node keeps): warc_ingest_long's
    pages_per_s × (ramp_s + seconds), and min_left pages on top. At this
    rate the node's warm-up and first batches take tens of seconds past
    ramp_s before the window opens, so without them the files leave a
    seed's window fewer than min_left pages (a traced run left 238)."""
    tr = run.traffic
    need = int(tr["pages_per_s"] * (tr["ramp_s"] + run.seconds)) \
        + tr["min_left"]
    seed = seeds.torch_seed(run.seed, seeds.PAGES)
    n = int(need / tr["languages"]["en"]) + 1
    while True:
        kept = int(long._corpus(seed, n, tr, run.config).kept().sum())
        if kept >= need:
            return n, kept
        n = int(n * need / max(kept, 1)) + 16


def prepare(run) -> dict:
    """The checkpoint, the seeded store and the WARC files; refuses at
    once a program without the Qwen3 family, before 15 GB are written."""
    import importlib.util

    import torch
    if importlib.util.find_spec("dawnsearch_tpu_torch.models.qwen3") is None:
        raise RuntimeError("dawnsearch_tpu_torch has no Qwen3 family "
                           "(models/qwen3.py): it cannot serve this cell")
    dev = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    written = write_checkpoint(run.model_dir, cfg, seeds.torch_seed(
        run.seed, seeds.WEIGHTS), dev)
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
    jobs = [(seeds.torch_seed(run.seed, seeds.PAGES), n, f, files, tr, cfg,
             os.path.join(wdir, f"CC-BENCH-{f:05d}.warc.gz"))
            for f in range(files)]
    import concurrent.futures as cf
    import multiprocessing as mp
    t0 = time.monotonic()
    with cf.ProcessPoolExecutor(min(files, tr["writers"]),
                                mp_context=mp.get_context("spawn")) as ex:
        warc_bytes = sum(ex.map(long._write_file, jobs))
    return {"bytes_written": written + warc_bytes, "warc_bytes": warc_bytes,
            "warc_s": time.monotonic() - t0, "files_pages": n,
            "pages": kept, "seeded": n_seed,
            "warc": os.path.join(wdir, "*.warc.gz")}


node_settings = long.node_settings


def _pages(run, manifest: dict) -> long.LongPages:
    return long._corpus(seeds.torch_seed(run.seed, seeds.PAGES),
                        manifest["files_pages"], run.traffic, run.config)


def run(run, node, manifest: dict, t_start: float) -> Window:
    """warc_ingest_long's window (it opens once the node inserts in steady
    state and closes as the first batch after `--seconds` lands), with
    this kind's searches and work counts."""
    tr = run.traffic
    m0 = _ramp(run, node)
    t0 = time.monotonic()
    s0 = node.get("/api/stats")
    cap = Capture(node, min(run.seconds, tr["trace_s"])) if run.trace \
        else None
    series = []
    while time.monotonic() < t0 + run.seconds - 1.0:
        time.sleep(1.0)
        series.append(node.get("/api/metrics").get("pages_inserted", 0)
                      - m0.get("pages_inserted", 0))
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
    w.trace = qwen3_readers.clip_to_capture(cap.result()) if cap else None
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
        w.flops = _flops(run, _pages(run, manifest), first, last)
    truncated = {k: w.delta(k) for k in (
        "encoder_texts_truncated", "encoder_tokens_truncated",
        "ingest_text_truncated")}
    w.lines += [
        f"pages inserted since the window opened, each second: {series}",
        f"pages inserted in the window {int(inserted)} in {w.seconds:.3f} s "
        f"({w.delta('ingest_insert_count'):.0f} insert batches); index "
        f"capacity {s1['index_capacity']}, {s1['pages_indexed']} pages; "
        f"{left} pages left in the files; cut in the window: {truncated}",
        f"setup_s {w.e2e['setup_s']!r} (prepare "
        f"{manifest['prepare_s']:.1f} s, of it WARC files "
        f"{manifest['warc_s']:.1f} s; {manifest['bytes_written']} bytes "
        f"written, of them WARC {manifest['warc_bytes']}; "
        f"{manifest['files_pages']} pages in the files, "
        f"{manifest['pages']} to keep)"]
    return w


def _search(run, node, want: list[int]) -> list[tuple[str, str]]:
    by_id = {r[0]: r for r in store.read_rows(run.data_dir, want,
                                              run.config["hidden_size"])}
    out = []
    for i in want:
        if i not in by_id:
            out.append(("missing", ""))
            continue
        _, url, title, text, _ = by_id[i]
        q = urllib.parse.quote(
            f"{title}\n{text[:run.traffic['query_chars']]}")
        res = node.get("/api/search?q=" + q)["results"]
        out.append((url, res[0]["url"] if res else ""))
    return out


def _found(run, node, first: int, last: int) -> list[tuple[str, str]]:
    """Search the node for `searched` pages of the window by their title
    and the first `query_chars` of their text: (url of the page, url of
    the first result)."""
    return _search(run, node, qwen3_work.page_sample(
        seeds.rng(run.seed, seeds.JUDGE), np.arange(first, last + 1),
        run.traffic["searched"]))


def _flops(run, pages, first: int, last: int) -> float:
    cfg = run.config
    words = vocab_words()
    total = 0.0
    for url in store.read_urls(run.data_dir, first, last):
        _, title, text = pages.stored(texts.Pages.index_of(url))
        n = qwen3_work.page_tokens(cfg["document_prompt"], title, text,
                                   words, cfg["seq_buckets"][-1])
        total += qwen3_work.encoder_flops(n, cfg)
    return total


def judge(run, window, manifest: dict) -> dict:
    """warc_ingest_long's checks: each sampled stored (url, title, text)
    against the WARC file's page (`text_mismatch`), its stored embedding
    against reference/qwen3.py's on the same bf16 weights, tokenized by
    reference/bpe_qwen.py (`emb_gap`, 1 - cosine), and each searched page
    at rank 1 (`not_found`)."""
    import torch

    from benchmark.reference import qwen3
    from benchmark.reference.bpe_qwen import QwenBPE
    dev = torch.device(run.device)
    cfg, lim = run.config, run.limits
    first, last = window.extra["first"], window.extra["last"]
    rng = seeds.rng(run.seed, seeds.JUDGE + 100)
    rows = store.read_rows(run.data_dir, qwen3_work.page_sample(
        rng, np.arange(first, last + 1), run.traffic["judged"]),
        cfg["hidden_size"])
    pages = _pages(run, manifest)
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
        combined.append(f"{cfg['document_prompt']}{title}\n{text}")
        stored.append(emb)
    gap = float("inf")
    if rows:
        tok = QwenBPE.from_json(os.path.join(run.model_dir,
                                             "tokenizer.json"))
        ref = qwen3.embed(
            weights(cfg, seeds.torch_seed(run.seed, seeds.WEIGHTS), dev),
            cfg, [tok.encode(c, cfg["seq_buckets"][-1]) for c in combined],
            dev).cpu().numpy()
        got = np.stack(stored)
        cos = (got * ref).sum(1) / np.maximum(
            np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1), 1e-30)
        gap = float((1.0 - cos).max())
    found = window.extra["found"]
    not_found = sum(a != b for a, b in found)
    window.lines.append(f"judged {len(rows)} pages of the window "
                        f"(ids {first}..{last}); searched {len(found)}")
    return {"emb_gap": {"value": gap, "limit": lim["emb_gap"]},
            "text_mismatch": {"value": mismatch, "limit": 0},
            "not_found": {"value": not_found, "limit": 0},
            "unjudged": {"value": max(0, lim["min_judged"] - len(rows)),
                         "limit": 0}}
