"""WARC ingest of whole long pages by a long-context encoder (ModernBERT).

warc_ingest's cell (kinds/warc_ingest.py: gzip WARC files in Common
Crawl's mix of languages and HTML sizes, over a store seeded with
`index_capacity × seeded_share` pages, the window between two insert
batches), with what a long-context model changes:

- the visible text of an English page is a lognormal count of words
  (`text_mean_tokens`, `text_sigma`; LongPages), each one token of the
  synthetic tokenizer.json, so a page's tokens are known without a BPE
  pass (modernbert_work.page_tokens); the node keeps up to the
  configuration's `ingest_max_text_chars` of it and cuts its tokens at the
  top seq bucket;
- the checkpoint is ModernBERT's (HF tensor names, `make_weights`) with a
  tokenizer.json of the published size and special ids
  (`tokenizer_json`), and the node runs with the configuration's seq
  buckets, text cap, prompts and pool;
- the judge tokenizes with reference/bpe.py and embeds with
  reference/modernbert.py, and searches each sampled page by its title and
  the first `query_chars` of its text (the GET line stays under the
  node's 65,536-byte limit).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import time
import urllib.parse

import numpy as np

from benchmark import modernbert_work, seeds, store, texts, warc, weights
from benchmark.kinds import warc_ingest
from benchmark.kinds.warc_ingest import SEED_URL, _ramp, _sample
from benchmark.window import Capture, Window

PAGE_KEYS = ("languages", "text_mean_tokens", "text_sigma",
             "html_mean_bytes", "html_sigma", "html_max_bytes")
MAX_WORDS = 10_000  # a page's words: the text stays inside the first
#                     250,000 bytes of its HTML that the node reads
SPECIALS = {"[UNK]": 50280, "[CLS]": 50281, "[SEP]": 50282, "[PAD]": 50283,
            "[MASK]": 50284}


class LongPages(texts.Pages):
    """texts.Pages whose English texts are `lengths[i]` words of the
    page's topic stream (words.txt and the stopwords, one token each) and
    a full stop, kept whole up to the node's `max_text` characters."""

    def __init__(self, seed: int, n: int, languages: dict,
                 text_mean_tokens: float, text_sigma: float,
                 html_mean_bytes: float, html_sigma: float,
                 html_max_bytes: int, max_text: int):
        super().__init__(seed, n, languages, text_mean_tokens, text_sigma,
                         html_mean_bytes, html_sigma, html_max_bytes)
        self.lengths = np.minimum(self.lengths, MAX_WORDS)
        self.max_text = max_text

    def kept(self) -> np.ndarray:
        """English pages: every one holds 100 words or more."""
        return self.lang == 0

    def text(self, i: int) -> str:
        if self.lang[i]:
            return self._foreign(i, min(int(self.lengths[i]) * 6, 12_000),
                                 tag=2)
        s = int(self.starts[i])
        table = [self._vocab[t] for t in self.topics[i]] + self._stop
        return " ".join(table[k] for k in
                        self._stream[s: s + int(self.lengths[i])]) + "."

    def stored(self, i: int) -> tuple[str, str, str]:
        return (self.url(i), self.title(i)[:texts.MAX_TITLE],
                " ".join(self.text(i).split())[:self.max_text])


def _corpus(seed: int, n: int, traffic: dict, config: dict) -> LongPages:
    return LongPages(seed, n, **{k: traffic[k] for k in PAGE_KEYS},
                     max_text=config["ingest_max_text_chars"])


# -- the checkpoint ---------------------------------------------------------

def make_weights(config: dict, seed: int, device) -> dict:
    """{HF ModernBertModel name: f32 tensor of bf16 values}: matrices std
    0.05, the token embeddings std 0.5, norm scales 1 + N(0, 0.1)
    (weights.py's laws; ModernBERT has no biases)."""
    import torch
    H, I = config["hidden_size"], config["intermediate_size"]
    mats = {"embeddings.tok_embeddings.weight": (config["vocab_size"], H)}
    vecs = ["embeddings.norm.weight", "final_norm.weight"]
    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        mats[p + "attn.Wqkv.weight"] = (3 * H, H)
        mats[p + "attn.Wo.weight"] = (H, H)
        mats[p + "mlp.Wi.weight"] = (2 * I, H)
        mats[p + "mlp.Wo.weight"] = (H, I)
        vecs += ([p + "attn_norm.weight"] if i else []) + \
            [p + "mlp_norm.weight"]
    g = torch.Generator(device=device).manual_seed(seed)
    flat_m = torch.randn(sum(a * b for a, b in mats.values()), generator=g,
                         device=device) * 0.05
    flat_v = torch.randn(len(vecs) * H, generator=g, device=device) * 0.1
    out, o = {}, 0
    for name, (a, b) in mats.items():
        t = flat_m[o:o + a * b].view(a, b)
        out[name] = t * 10.0 if name.startswith("embeddings.") else t
        o += a * b
    for k, name in enumerate(vecs):
        out[name] = flat_v[k * H:(k + 1) * H] + 1.0
    return {k: v.to(torch.bfloat16).float() for k, v in out.items()}


def tokenizer_json(vocab_size: int) -> dict:
    """A `tokenizers` file of ModernBERT's layout at its published size:
    256 byte tokens, merges that make a space and each word of words.txt
    (and the stopwords) one token, a letter at a time, filler up to the
    published special ids ([UNK] 50280, [CLS] 50281, [SEP] 50282, [PAD]
    50283, [MASK] 50284) and after them up to vocab_size; no normalizer,
    the ByteLevel pre-tokenizer without a prefix space, [CLS] $A [SEP]."""
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
    first = min(SPECIALS.values())
    if len(vocab) > first:
        raise ValueError(f"{len(vocab)} tokens do not fit below {first}")
    for k in range(len(vocab), first):
        vocab[f"<|filler_{k}|>"] = k
    added = dict(SPECIALS)
    for k in range(first + len(SPECIALS), vocab_size):
        added[f"[unused{k - first - len(SPECIALS)}]"] = k
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": c in SPECIALS}
                         for c, i in added.items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {
                n: {"id": n, "ids": [SPECIALS[n]], "tokens": [n]}
                for n in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}


def write_checkpoint(model_dir: str, config: dict, tensors: dict) -> int:
    """config.json, model.safetensors (F32) and tokenizer.json."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config["published"], f, indent=2)
    with open(os.path.join(model_dir, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(tokenizer_json(config["vocab_size"]), f,
                  ensure_ascii=False)
    return weights.write_safetensors(
        tensors, os.path.join(model_dir, "model.safetensors"))


# -- set-up, window, judge ----------------------------------------------------

def _page_count(run) -> tuple[int, int]:
    tr = run.traffic
    need = int(tr["pages_per_s"] * (tr["ramp_s"] + run.seconds))
    seed = seeds.torch_seed(run.seed, seeds.PAGES)
    n = int(need / tr["languages"]["en"]) + 1
    while True:
        kept = int(_corpus(seed, n, tr, run.config).kept().sum())
        if kept >= need:
            return n, kept
        n = int(n * need / max(kept, 1)) + 16


def _write_file(args) -> int:
    seed, n, f, files, traffic, config, path = args
    return warc.write(path, _corpus(seed, n, traffic, config),
                      range(f, n, files))


def prepare(run) -> dict:
    import torch
    dev = torch.device(run.device)
    cfg, tr = run.config, run.traffic
    W = make_weights(cfg, seeds.torch_seed(run.seed, seeds.WEIGHTS), dev)
    written = write_checkpoint(run.model_dir, cfg, W)
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
    jobs = [(seeds.torch_seed(run.seed, seeds.PAGES), n, f, files, tr, cfg,
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
    cfg = run.config
    return {**warc_ingest.node_settings(run),
            "DAWNSEARCH_SEQ_BUCKETS": ",".join(map(str, cfg["seq_buckets"])),
            "DAWNSEARCH_INGEST_MAX_TEXT_CHARS":
                str(cfg["ingest_max_text_chars"]),
            "DAWNSEARCH_DOCUMENT_PROMPT": cfg["document_prompt"],
            "DAWNSEARCH_QUERY_PROMPT": cfg["query_prompt"],
            "DAWNSEARCH_POOL_IMPL": cfg["pool_impl"]}


def run(run, node, manifest: dict, t_start: float) -> Window:
    """warc_ingest.run's window (it opens once the node inserts in steady
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
    truncated = {k: w.delta(k) for k in (
        "encoder_texts_truncated", "encoder_tokens_truncated",
        "ingest_text_truncated")}
    w.lines += [
        f"pages inserted since the window opened, each second: {series}",
        f"pages inserted in the window {int(inserted)} in {w.seconds:.3f} s; "
        f"index capacity {s1['index_capacity']}, {s1['pages_indexed']} "
        f"pages; {left} pages left in the files; cut in the window: "
        f"{truncated}",
        f"setup_s {w.e2e['setup_s']!r} (prepare "
        f"{manifest['prepare_s']:.1f} s, of it WARC files "
        f"{manifest['warc_s']:.1f} s; {manifest['bytes_written']} bytes "
        f"written, of them WARC {manifest['warc_bytes']}; "
        f"{manifest['files_pages']} pages in the files, "
        f"{manifest['pages']} to keep)"]
    return w


def _found(run, node, first: int, last: int) -> list[tuple[str, str]]:
    """Search the node for sampled pages of the window by their title and
    the first `query_chars` of their text: (url of the page, url of the
    first result)."""
    want = _sample(run, first, last, run.traffic["searched"])
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


def _flops(run, manifest: dict, first: int, last: int) -> float:
    cfg = run.config
    pages = _corpus(seeds.torch_seed(run.seed, seeds.PAGES),
                    manifest["files_pages"], run.traffic, cfg)
    words = modernbert_work.vocab_words()
    total = 0.0
    for url in store.read_urls(run.data_dir, first, last):
        _, title, text = pages.stored(texts.Pages.index_of(url))
        n = modernbert_work.page_tokens(cfg["document_prompt"], title, text,
                                        words, cfg["seq_buckets"][-1])
        total += modernbert_work.encoder_flops(n, cfg)
    return total


def judge(run, window, manifest: dict) -> dict:
    """warc_ingest's checks: each sampled stored (url, title, text) against
    the WARC file's page (`text_mismatch`), its stored embedding against
    reference/modernbert.py's on the same bf16-rounded weights, tokenized
    by reference/bpe.py (`emb_gap`, 1 - cosine), and each searched page
    at rank 1 (`not_found`)."""
    import torch

    from benchmark.reference import modernbert
    from benchmark.reference.bpe import ByteLevelBPE
    dev = torch.device(run.device)
    cfg, lim = run.config, run.limits
    first, last = window.extra["first"], window.extra["last"]
    rows = store.read_rows(run.data_dir,
                           _sample(run, first, last, run.traffic["judged"]),
                           cfg["hidden_size"])
    pages = _corpus(seeds.torch_seed(run.seed, seeds.PAGES),
                    manifest["files_pages"], run.traffic, cfg)
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
    tok = ByteLevelBPE.from_json(os.path.join(run.model_dir,
                                              "tokenizer.json"))
    W = make_weights(cfg, seeds.torch_seed(run.seed, seeds.WEIGHTS), dev)
    ref = modernbert.embed(W, cfg, [tok.encode(c, cfg["seq_buckets"][-1])
                                    for c in combined], dev).cpu().numpy()
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
