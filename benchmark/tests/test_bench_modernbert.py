"""The long-ingest cell (kinds/warc_ingest_long.py) on the CPU: its pages
as the node keeps them, its token counts by construction against the
reference BPE (and that against `tokenizers`), and whole runs of a tiny
ModernBERT (3 layers, 64 wide, a window of ±4, buckets to 1,024): a sound
node comes out correct; the window turned off, the document prompt
dropped, or the text cap left at DawnSearch's 2,048 characters come out
not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import modernbert_work, spec, texts, warc
from benchmark.kinds import warc_ingest_long as kind
from benchmark.reference.bpe import ByteLevelBPE, pretokenize
from benchmark.tests.conftest import BENCH, HERE, LANGUAGES, ROOT

CFG = spec.config("modernbert-embed-base-i8-1m")
TRAFFIC = spec.traffic("warc-ingest-long")
MIX = {k: TRAFFIC[k] for k in kind.PAGE_KEYS}


@pytest.fixture(scope="module")
def tokenizer_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    path.write_text(json.dumps(kind.tokenizer_json(CFG["vocab_size"])))
    return str(path)


def test_pages_as_the_node_keeps_them(tmp_path):
    """The port's WARC reader, extractor and filters, at the cell's text
    cap, keep exactly the English pages, each whole as LongPages.stored()
    has it."""
    from dawnsearch_tpu_torch.ingest.pages import iter_pages
    pages = kind.LongPages(7, 120, **MIX, max_text=CFG[
        "ingest_max_text_chars"])
    path = str(tmp_path / "t.warc.gz")
    warc.write(path, pages, range(120))
    got = list(iter_pages(path, max_text=CFG["ingest_max_text_chars"]))
    want = np.flatnonzero(pages.kept()).tolist()
    assert [texts.Pages.index_of(p.url) for p in got] == want
    assert all((p.url, p.title, p.text) == pages.stored(
        texts.Pages.index_of(p.url)) for p in got)
    lengths = pages.lengths[want]
    assert lengths.max() <= kind.MAX_WORDS and lengths.mean() > 1500


def test_token_counts_by_construction(tokenizer_path):
    """modernbert_work.page_tokens equals the reference BPE's count on
    pages of the cell, cut at the top bucket and not."""
    tok = ByteLevelBPE.from_json(tokenizer_path)
    pages = kind.LongPages(3, 60, **MIX, max_text=CFG[
        "ingest_max_text_chars"])
    words = modernbert_work.vocab_words()
    top = CFG["seq_buckets"][-1]
    cut = 0
    for i in np.flatnonzero(pages.kept())[:12]:
        _, title, text = pages.stored(int(i))
        for max_len in (top, 1 << 20):
            want = len(tok.encode(f"{CFG['document_prompt']}{title}\n{text}",
                                  max_len))
            got = modernbert_work.page_tokens(CFG["document_prompt"], title,
                                              text, words, max_len)
            assert got == want
        cut += want > top
    assert modernbert_work.token_count(
        " the cat 12 x.\n  ab: search_document: q", words) == len(
            tok.encode(" the cat 12 x.\n  ab: search_document: q")) - 2


def _mixed_texts(rng, n):
    pool = ["the", "cat", "naïve", "café", "北京", "東京都", "😀", "🚀x",
            "  ", "\n", "\t", "'s", "don't", "123", "4.5", "!!", "Ωmega",
            "ﬁ", "é", " ", "über", "São"]
    return ["".join(rng.choice(pool, int(rng.integers(1, 40))))
            for _ in range(n)]


def test_reference_bpe_matches_tokenizers(tokenizer_path):
    """reference/bpe.py gives `tokenizers`' ids on the synthetic file:
    ASCII, accents, CJK, emoji, runs of spaces, and the cut at 8,192."""
    tk = pytest.importorskip("tokenizers")
    ref = tk.Tokenizer.from_file(tokenizer_path)
    ref.enable_truncation(8192)
    mine = ByteLevelBPE.from_json(tokenizer_path)
    rng = np.random.default_rng(5)
    long = " ".join(texts.words()) * 8
    for t in _mixed_texts(rng, 200) + [long]:
        assert mine.encode(t, 8192) == ref.encode(t).ids, t
    assert "".join(pretokenize("a  b\n c")) == "a  b\n c"


def _tiny_spec(tmp_path):
    """A folder of one tiny long-ingest cell beside the real readers."""
    import shutil
    d = tmp_path
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    shutil.copytree(os.path.join(BENCH, "metrics"), d / "metrics")
    cfg = dict(CFG, hidden_size=64, num_attention_heads=4,
               intermediate_size=96, num_hidden_layers=3, local_attention=8,
               max_position_embeddings=1024, index_capacity=8192,
               compute_dtype="f32", ingest_workers=1, pool_impl="xla",
               seq_buckets=[16, 32, 64, 128, 256, 512, 1024])
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = dict(TRAFFIC, files=2, writers=2, pages_per_s=100,
              text_mean_tokens=300, html_mean_bytes=20000, min_left=16,
              judged=16, searched=4, trace_s=6, seeded_share=0.5,
              ramp_timeout_s=120, languages=LANGUAGES)
    (d / "traffic" / "tiny-long.json").write_text(json.dumps(tr))
    # f32 twins against the f32 reference: sound runs read about 1e-7
    (d / "limits" / "tiny-long.json").write_text(json.dumps(
        {"emb_gap": 1e-5, "min_judged": 8}))
    bench = {"workloads": [{"name": "tiny-long", "config": "tiny",
                            "traffic": "tiny-long", "chips": 1,
                            "why": "CPU test"}],
             "end_to_end": [{"name": "ingest_pages_s", "unit": "pages/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": n, "unit": "%",
                            "workloads": ["tiny-long"]}
                           for n in ("mfu.long", "encoder_pad.long",
                                     "attn_local_roofline.long")]}
    (d / "bench.json").write_text(json.dumps(bench))
    from benchmark.tests.conftest import DRIVER
    (d / "tiny_run.py").write_text(DRIVER.format(root=ROOT, here=str(d)))
    return d


@pytest.fixture(scope="module")
def tiny_long(tmp_path_factory):
    return _tiny_spec(tmp_path_factory.mktemp("tinylong"))


def _run(d, fault=None, env_extra=None, trace=0) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    node_env = {"DAWNSEARCH_INGEST_BATCH_SIZE": "16", **(env_extra or {})}
    if fault:
        env["TINY_NODE_CMD"] = json.dumps(
            [sys.executable, os.path.join(HERE, "faulty_long_node.py")])
        node_env["BENCH_FAULT"] = fault
    env["TINY_NODE_ENV"] = json.dumps(node_env)
    p = subprocess.run(
        [sys.executable, str(d / "tiny_run.py"), "--workload", "tiny-long",
         "--seed", "3000000019", "--seconds", "12", "--trace", str(trace)],
        capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault,env", [
    (None, None), ("window", None),
    (None, {"DAWNSEARCH_DOCUMENT_PROMPT": ""}),
    (None, {"DAWNSEARCH_INGEST_MAX_TEXT_CHARS": "2048"})])
def test_long_ingest_on_the_cpu(tiny_long, fault, env):
    out = _run(tiny_long, fault, env)
    sound = fault is None and env is None
    assert out["correct"] is sound, out["checks"]
    assert out["metrics"]["ingest_pages_s"]["value"] > 0


def test_long_ingest_traced_on_the_cpu(tiny_long):
    out = _run(tiny_long, trace=1)
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"]["mfu.long"]["value"]
    assert 0 <= out["metrics"]["encoder_pad.long"]["value"] < 100


def test_work_counts_by_hand():
    """220.6 MFLOP a token for the projections at ModernBERT-base; 4·H a
    key; the band cut at the edges; 8 global and 14 local layers."""
    assert modernbert_work.layer_kinds(CFG) == (8, 14)
    per = modernbert_work.projection_flops(CFG)
    assert abs(per / 22 - 2 * (4 * 768 ** 2 + 3 * 768 * 1152)) < 1
    assert abs(per - 220.6e6) < 0.1e6
    assert modernbert_work.band_keys(5, 1) == 13   # 2 + 3 + 3 + 3 + 2
    assert modernbert_work.band_keys(200, 64) == sum(
        min(i + 64, 199) - max(i - 64, 0) + 1 for i in range(200))
    n = 1000
    want = n * per + 4 * 768 * (8 * n * n + 14 * modernbert_work.band_keys(
        n, 64))
    assert modernbert_work.encoder_flops(n, CFG) == want
    flops, nbytes = modernbert_work.attention_work(100, 10, 2, 8, 768)
    assert flops == 4 * 768 * 100 and nbytes == 2 * 768 * (30 + 16)


def _trace(events):
    from benchmark.trace import Trace
    return Trace(events, span_s=0.01)


def test_long_readers_on_a_synthetic_trace():
    """Each share is the work's bound over its spans' kernels' time, the
    kernels found by correlation id; no span, no number."""
    from benchmark import long_readers, peaks
    from benchmark.window import Window

    def span(name, ts, dur, **args):
        return {"ph": "X", "cat": "dawn", "name": name, "ts": ts,
                "dur": dur, "pid": 1, "tid": 7, "args": args}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "pid": 1, "tid": 7,
                "args": {"correlation": corr}}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur, "args": {"correlation": corr}}
    a = dict(kind="local", B=2, S=1024, window=64, theta=1e4, real=1500,
             keys=1500 * 129)
    ev = [span("encoder.forward", 0, 100, B=2, S=1024, real=1500),
          span("encoder.attn", 10, 10, **a), launch(12, 1),
          kernel(200, 50, 1),
          span("encoder.ffn", 30, 10, B=2, S=1024), launch(32, 2),
          launch(34, 3), kernel(300, 40, 2), kernel(400, 60, 3)]
    w = Window(0, 1, {}, {}, CFG)
    assert long_readers.geglu_roofline(w) is None  # no trace
    w.trace = _trace(ev)
    fl, nb = modernbert_work.attention_work(a["keys"], 1500, 2, 1024, 768)
    bound = max(fl / peaks.BF16_FLOPS, nb / peaks.HBM_BYTES_PER_S)
    got = long_readers.attn_roofline("local")(w)
    assert abs(got - 100 * bound / 50e-6) < 1e-9
    assert long_readers.attn_roofline("global")(w) is None
    fl, nb = modernbert_work.geglu_work(2, 1024, CFG)
    got = long_readers.geglu_roofline(w)
    assert abs(got - 100 * max(fl / peaks.BF16_FLOPS,
                               nb / peaks.HBM_BYTES_PER_S) / 100e-6) < 1e-9
    flops = 2 * 1024 * modernbert_work.projection_flops(CFG) \
        + 4 * 768 * a["keys"]
    got = long_readers.encoder_roofline(w)
    assert abs(got - 100 * flops / (150e-6 * peaks.BF16_FLOPS)) < 1e-9
