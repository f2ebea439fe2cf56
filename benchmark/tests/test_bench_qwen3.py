"""The Qwen3 long-ingest cell (kinds/warc_ingest_qwen3.py) on the CPU: its
token counts by construction against the reference BPE of Qwen3's layout
(and that against `tokenizers`), its work counts by hand, its readers on a
synthetic trace, and whole runs of a tiny Qwen3 (2 layers, 256 wide: 2
query heads of 128 over 1 key/value head, buckets to 1,024): a sound node
comes out correct; attention without its causal mask, or the first token
pooled, come out not correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import qwen3_work as work
from benchmark import spec
from benchmark.kinds import warc_ingest_qwen3 as kind
from benchmark.reference.bpe_qwen import QwenBPE, pretokenize
from benchmark.tests.conftest import BENCH, HERE, LANGUAGES, ROOT

CFG = spec.config("qwen3-embedding-8b-i8-1m")
TRAFFIC = spec.traffic("warc-ingest-qwen3")
MIX = {k: TRAFFIC[k] for k in kind.PAGE_KEYS}


@pytest.fixture(scope="module")
def tokenizer_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    path.write_text(json.dumps(kind.tokenizer_json(CFG["vocab_size"]),
                               ensure_ascii=False))
    return str(path)


def test_token_counts_by_construction(tokenizer_path):
    """qwen3_work.page_tokens equals the reference BPE's count on pages of
    the cell, cut at the top bucket and not; the cut keeps <|endoftext|>
    last."""
    tok = QwenBPE.from_json(tokenizer_path)
    pages = kind.long.LongPages(3, 200, **MIX, max_text=CFG[
        "ingest_max_text_chars"])
    words = kind.vocab_words()
    top = CFG["seq_buckets"][-1]
    cut = 0
    kept = np.flatnonzero(pages.kept())
    longest = kept[np.argsort(-pages.lengths[kept])]
    for i in list(longest[:4]) + list(kept[:8]):
        _, title, text = pages.stored(int(i))
        for max_len in (top, 1 << 20):
            ids = tok.encode(f"{CFG['document_prompt']}{title}\n{text}",
                             max_len)
            assert ids[-1] == kind.EOS
            got = work.page_tokens(CFG["document_prompt"], title, text,
                                   words, max_len)
            assert got == len(ids)
        cut += len(ids) > top
    assert cut > 0
    s = " the cat 12 x.\n  ab: don't IT'S\n\n q"
    assert work.token_count(s, words) == len(tok.encode(s)) - 1


def _mixed_texts(rng, n):
    pool = ["the", "cat", "naïve", "café", "北京", "東京都", "😀", "🚀x",
            "  ", "\n", "\t", "'s", "don't", "DON'T", "123", "4.5", "!!",
            "Ωmega", "ﬁ", "é", " ", "über", "São", "\r\n", "(word",
            "...x", " .\n", ",,\n\n", "1,000", "I'LL"]
    return ["".join(rng.choice(pool, int(rng.integers(1, 40))))
            for _ in range(n)]


def test_reference_bpe_matches_tokenizers(tokenizer_path):
    """reference/bpe_qwen.py gives `tokenizers`' ids on the synthetic file
    of Qwen3's layout: digits, contractions, newlines, punctuation,
    non-Latin text, and the cut at 8,192 with <|endoftext|> kept."""
    tk = pytest.importorskip("tokenizers")
    ref = tk.Tokenizer.from_file(tokenizer_path)
    ref.enable_truncation(8192)
    mine = QwenBPE.from_json(tokenizer_path)
    rng = np.random.default_rng(5)
    long = " ".join(kind.texts.words()) * 8
    for t in _mixed_texts(rng, 300) + [long, CFG["query_prompt"] + "x"]:
        assert mine.encode(t, 8192) == ref.encode(t).ids, t
    assert "".join(pretokenize("a  b\n c\r\n\n  d")) == "a  b\n c\r\n\n  d"


def test_work_counts_by_hand():
    """13.89 GFLOP a token for the projections at Qwen3-Embedding-8B; 4·nh·
    hd a key, n(n + 1) / 2 keys causal; each span's bytes."""
    per = work.projection_flops(CFG)
    assert per == 2 * 36 * (4096 * 6144 + 4096 * 4096 + 3 * 4096 * 12288)
    assert abs(per - 13.89e9) < 0.01e9
    assert work.causal_keys(4) == 10
    n = 3000
    assert work.encoder_flops(n, CFG) == n * per + 36 * 4 * 4096 * (
        n * (n + 1) // 2)
    flops, nbytes = work.attention_work(100, 10, 2, 8, CFG)
    assert flops == 4 * 4096 * 100
    assert nbytes == 2 * 128 * (48 * 10 + 32 * 16)
    flops, nbytes = work.swiglu_work(2, 8, CFG)
    assert flops == 2 * 16 * 3 * 4096 * 12288
    flops, _ = work.proj_work("qkv", 2, 8, CFG)
    assert flops == 2 * 16 * 4096 * 6144
    flops, _ = work.proj_work("out", 2, 8, CFG)
    assert flops == 2 * 16 * 4096 * 4096
    assert sum(np.prod(s) for s in work.shapes(CFG).values()) == (
        151665 * 4096 + 4096 + 36 * (2 * 4096 + 2 * 128 + 4096 * 6144
                                     + 4096 * 4096 + 3 * 4096 * 12288))


def _trace(events):
    from benchmark.trace import Trace
    return Trace(events, span_s=0.01)


def test_qwen3_readers_on_a_synthetic_trace():
    """Each share is the work's bound over its spans' kernels' time, the
    kernels found by correlation id; no span, no number."""
    from benchmark import peaks, qwen3_readers
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

    def bound(fl, nb):
        return max(fl / peaks.BF16_FLOPS, nb / peaks.HBM_BYTES_PER_S)
    a = dict(kind="causal", B=2, S=1024, heads=32, kv_heads=8, real=1500,
             keys=1000 * 1001 // 2 + 500 * 501 // 2)
    ev = [span("encoder.forward", 0, 100, B=2, S=1024, real=1500),
          span("encoder.proj", 5, 4, kind="qkv", B=2, S=1024),
          launch(6, 4), kernel(100, 30, 4),
          span("encoder.attn", 10, 10, **a), launch(12, 1),
          kernel(200, 50, 1),
          span("encoder.proj", 22, 4, kind="out", B=2, S=1024),
          launch(23, 5), kernel(260, 20, 5),
          span("encoder.ffn", 30, 10, B=2, S=1024), launch(32, 2),
          launch(34, 3), kernel(300, 40, 2), kernel(400, 60, 3)]
    w = Window(0, 1, {}, {}, CFG)
    assert qwen3_readers.swiglu_roofline(w) is None  # no trace
    w.trace = _trace(ev)
    got = qwen3_readers.attn_roofline(w)
    want = bound(*work.attention_work(a["keys"], 1500, 2, 1024, CFG))
    assert abs(got - 100 * want / 50e-6) < 1e-9
    got = qwen3_readers.swiglu_roofline(w)
    want = bound(*work.swiglu_work(2, 1024, CFG))
    assert abs(got - 100 * want / 100e-6) < 1e-9
    got = qwen3_readers.proj_roofline(w)
    want = bound(*work.proj_work("qkv", 2, 1024, CFG)) + bound(
        *work.proj_work("out", 2, 1024, CFG))
    assert abs(got - 100 * want / 50e-6) < 1e-9
    flops = 2 * 1024 * work.projection_flops(CFG) + 4 * 4096 * a["keys"]
    got = qwen3_readers.encoder_roofline(w)
    assert abs(got - 100 * flops / (200e-6 * peaks.BF16_FLOPS)) < 1e-9
    w.trace = _trace([e for e in ev if e.get("args", {}).get("kind")
                      not in ("causal", "qkv", "out")])
    assert qwen3_readers.attn_roofline(w) is None
    assert qwen3_readers.proj_roofline(w) is None


def test_qwen3_device_idle_counts_the_capture_alone():
    """Kernels that run past the capture's span (a device-bound pipeline
    leaves queued ones) count only inside it once the kind clips the
    trace: busy_s stays at most the window and the share in [0, 100],
    where the unclipped union would read more busy time than the window."""
    from benchmark import qwen3_readers, spec
    from benchmark.window import Window
    read = spec.metric_reader("device_idle.qwen3")

    def kernel(ts, dur):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts,
                "dur": dur}
    w = Window(0.0, 1.0, {}, {}, CFG)
    # 10 ms asked for: busy 0-4 ms and 6-13 ms from the first event
    w.trace = _trace([kernel(100, 4000), kernel(6100, 7000)])
    assert w.trace.busy_s > w.trace.span
    w.trace = qwen3_readers.clip_to_capture(w.trace)
    assert abs(w.trace.busy_s - 8e-3) < 1e-12
    assert abs(read(w) - 100 * (1 - 8e-3 / 1e-2)) < 1e-9
    # the kernels stay whole for the rooflines
    n, t = w.trace.kernel_time("k")
    assert n == 2 and abs(t - 11e-3) < 1e-12
    # inside the span the clip changes nothing
    w.trace = _trace([kernel(100, 2000), kernel(5100, 1000)])
    before = w.trace.busy_intervals
    w.trace = qwen3_readers.clip_to_capture(w.trace)
    assert w.trace.busy_intervals == before
    assert abs(read(w) - 100 * (1 - 3e-3 / 1e-2)) < 1e-9
    assert qwen3_readers.clip_to_capture(None) is None
    w.trace = None
    assert read(w) is None


# the cell's program-counter readers, shared with the other ingest cells
PIPELINE = ("encoder_pad.qwen3", "insert_wait.qwen3", "insert_readback.qwen3",
            "insert_screen.qwen3", "insert_store.qwen3")


def _tiny_spec(tmp_path):
    """A folder of one tiny Qwen3 cell beside the real readers."""
    import shutil
    d = tmp_path
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    shutil.copytree(os.path.join(BENCH, "metrics"), d / "metrics")
    cfg = dict(CFG, hidden_size=256, num_attention_heads=2,
               num_key_value_heads=1, intermediate_size=384,
               num_hidden_layers=2, max_position_embeddings=1024,
               index_capacity=8192, compute_dtype="f32", ingest_workers=1,
               seq_buckets=[16, 32, 64, 128, 256, 512, 1024])
    cfg["published"] = {k: cfg[k] for k in cfg["published_keys"]}
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = dict(TRAFFIC, files=2, writers=2, pages_per_s=100,
              text_mean_tokens=300, html_mean_bytes=20000, min_left=16,
              judged=16, searched=4, trace_s=6, seeded_share=0.5,
              ramp_timeout_s=120, languages=LANGUAGES)
    (d / "traffic" / "tiny-qwen3.json").write_text(json.dumps(tr))
    # f32 twins against the f32 reference: sound runs read about 1e-7
    (d / "limits" / "tiny-qwen3.json").write_text(json.dumps(
        {"emb_gap": 1e-5, "min_judged": 8}))
    bench = {"workloads": [{"name": "tiny-qwen3", "config": "tiny",
                            "traffic": "tiny-qwen3", "chips": 1,
                            "why": "CPU test"}],
             "end_to_end": [{"name": "ingest_pages_s", "unit": "pages/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": n, "unit": "%",
                            "workloads": ["tiny-qwen3"]}
                           for n in ("mfu.qwen3",) + PIPELINE]}
    (d / "bench.json").write_text(json.dumps(bench))
    from benchmark.tests.conftest import DRIVER
    (d / "tiny_run.py").write_text(DRIVER.format(root=ROOT, here=str(d)))
    return d


@pytest.fixture(scope="module")
def tiny_qwen3(tmp_path_factory):
    return _tiny_spec(tmp_path_factory.mktemp("tinyqwen3"))


def _run(d, fault=None, trace=0) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    node_env = {"DAWNSEARCH_INGEST_BATCH_SIZE": "16"}
    if fault:
        env["TINY_NODE_CMD"] = json.dumps(
            [sys.executable, os.path.join(HERE, "faulty_qwen3_node.py")])
        node_env["BENCH_FAULT"] = fault
    env["TINY_NODE_ENV"] = json.dumps(node_env)
    p = subprocess.run(
        [sys.executable, str(d / "tiny_run.py"), "--workload", "tiny-qwen3",
         "--seed", "3000000019", "--seconds", "12", "--trace", str(trace)],
        capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "causal", "first"])
def test_qwen3_ingest_on_the_cpu(tiny_qwen3, fault):
    out = _run(tiny_qwen3, fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["checks"]["emb_gap"]["value"] < 1e-5 or fault
    assert out["metrics"]["ingest_pages_s"]["value"] > 0


def test_qwen3_ingest_traced_on_the_cpu(tiny_qwen3):
    out = _run(tiny_qwen3, trace=1)
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"]["mfu.qwen3"]["value"]
    for name in PIPELINE:
        assert 0 <= out["metrics"][name]["value"] <= 100, name
