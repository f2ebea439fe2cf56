"""The port's program spans and counters.

- The span recorder (utils/logging.py::SpanRecorder) records nothing
  while no capture runs; an /api/profile capture
  (serving/http_service.py::capture_profile) writes its spans into the
  Chrome trace, with their args and parents, on the profiler's clock,
  and its waits as async "b"/"e" pairs.
- A batcher's requests wait as `<name>.wait`, and the spans of their
  batch carry their ids.
- A CPU node ingesting a local WARC file with one extraction worker: the
  insert thread's spans tile it during a capture, the worker's
  `extract.record` spans come under the worker's pid, and /api/metrics
  holds the worker's stage seconds and counts and the insert thread's.
- Timer counts are running counts, past the 1,000 samples kept.

The benchmark's readers of these are tested in
benchmark/tests/test_bench_program_readers.py.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from dawnsearch_tpu_torch.config import Config
from dawnsearch_tpu_torch.ingest import warc
from dawnsearch_tpu_torch.models.bert import BertConfig
from dawnsearch_tpu_torch.models.tokenizer import build_vocab_from_corpus
from dawnsearch_tpu_torch.models.weights import (params_from_numpy,
                                                 save_safetensors)
from dawnsearch_tpu_torch.node import DawnNode
from dawnsearch_tpu_torch.serving import http_service
from dawnsearch_tpu_torch.serving.batcher import CoalescingBatcher
from dawnsearch_tpu_torch.utils.logging import (METRICS, SPANS, Metrics,
                                                SpanRecorder, span, wait_span)

torch.set_num_threads(2)


def _dawn(path: str) -> list[dict]:
    """The trace's spans ("X") and the begins of its waits ("b")."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "dawn" and e["ph"] in "Xb"]


def _while_capturing(tmp_path, seconds: float, work) -> str:
    """Run `work()` on a thread of its own while a capture of `seconds`
    runs here; returns the trace's path."""
    done = threading.Event()

    def run():
        while not SPANS.on:
            time.sleep(0.001)
        work(done)
    t = threading.Thread(target=run, name="span-worker")
    t.start()
    try:
        return http_service.capture_profile(str(tmp_path), seconds)
    finally:
        done.set()
        t.join(30)
        assert not t.is_alive()


def test_no_capture_records_nothing():
    rec = SpanRecorder()
    assert not rec.on
    assert rec.span("a") is rec.span("b", n=1)  # one shared no-op
    assert rec.wait("w") is rec.span("a")
    with rec.span("a", n=1), rec.args(batches=["1.0"]), rec.wait("w"):
        pass
    rec.record("wait", 0, 10)
    rec.extend(1, 2, "w", [("extract.record", 0, 10, {}, "X")])
    assert rec.take() == ([], {})
    assert not SPANS.on and span("x") is span("y")


def test_capture_writes_spans_with_args_and_parents(tmp_path):
    tids = []

    def work(done):
        tids.append(threading.get_native_id())
        while not done.is_set():
            with SPANS.args(batches=["7.0"]), span("outer", n=3):
                with span("inner", late=True):
                    time.sleep(0.002)

    path = _while_capturing(tmp_path, 0.4, work)
    dawn = _dawn(path)
    outer = {e["args"]["span_id"]: e for e in dawn if e["name"] == "outer"}
    inner = [e for e in dawn if e["name"] == "inner"]
    assert len(outer) >= 5 and len(inner) >= 5
    for e in outer.values():
        assert e["args"]["n"] == 3 and e["args"]["batches"] == ["7.0"]
        assert e["args"]["parent_id"] is None
    for e in inner:
        assert e["args"]["late"] is True and e["args"]["batches"] == ["7.0"]
        assert e["args"]["parent"] == "outer"
        p = outer.get(e["args"]["parent_id"])
        if p is not None:  # the last outer may end after the capture
            assert p["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    assert {(e["pid"], e["tid"]) for e in dawn} == {(os.getpid(), tids[0])}


def test_waits_are_written_as_async_pairs(tmp_path):
    """A wait is a "b"/"e" pair with one id, not an "X" event, so the
    benchmark names no device-idle gap after it; it keeps its args and
    its parent."""
    def work(done):
        while not done.is_set():
            with span("outer"), wait_span("outer.wait", n=2):
                time.sleep(0.002)

    path = _while_capturing(tmp_path, 0.3, work)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("name") == "outer.wait"]
    begins = {e["id"]: e for e in events if e["ph"] == "b"}
    ends = {e["id"]: e for e in events if e["ph"] == "e"}
    assert len(begins) >= 5 and begins.keys() == ends.keys()
    assert {e["ph"] for e in events} == {"b", "e"}
    for i, b in begins.items():
        assert b["args"]["n"] == 2 and b["args"]["parent"] == "outer"
        assert b["cat"] == ends[i]["cat"] == "dawn"
        assert (b["pid"], b["tid"]) == (ends[i]["pid"], ends[i]["tid"])
        assert ends[i]["ts"] - b["ts"] >= 1000  # the 2 ms sleep, in µs


def test_batcher_requests_wait_and_their_batch_carries_them(tmp_path):
    """Each request's time from submit to the batcher's take is the wait
    `<name>.wait` on the submitting thread; spans opened while its batch
    is processed carry the batch's request ids."""
    def process(payloads):
        with span("probe.process", n=len(payloads)):
            time.sleep(0.002)
        return payloads

    b = CoalescingBatcher(process, max_batch=4, max_wait_ms=2.0,
                          name="probe")
    tids = []

    def work(done):
        tids.append(threading.get_native_id())
        while not done.is_set():
            futs = [b.submit(i) for i in range(3)]
            assert [f.result(10) for f in futs] == [0, 1, 2]

    try:
        path = _while_capturing(tmp_path, 0.4, work)
    finally:
        b.stop()
    dawn = _dawn(path)
    waits = [e for e in dawn if e["name"] == "probe.wait"]
    spans = [e for e in dawn if e["name"] == "probe.process"]
    assert waits and spans
    assert all(e["ph"] == "b" and e["tid"] == tids[0] for e in waits)
    asked = {e["args"]["request"] for e in waits}
    carried = [r for e in spans for r in e["args"]["requests"]]
    assert carried and set(carried) <= asked
    assert all(e["ph"] == "X" and e["tid"] != tids[0] for e in spans)


def test_spans_land_on_the_profilers_clock(tmp_path):
    """A span and a record_function opened at the same moment start and
    end within 1 ms of each other in the exported trace (a pair whose
    opens or closes this thread took over 1 ms for, preempted between
    them, is not at the same moment)."""
    took = {}

    def work(done):
        for i in range(10):
            t0 = time.time_ns()
            with span("probe", i=i), record_function(f"probe.rf{i}"):
                t1 = time.time_ns()
                time.sleep(0.003)
                t2 = time.time_ns()
            took[i] = max(t1 - t0, time.time_ns() - t2)
            time.sleep(0.005)

    path = _while_capturing(tmp_path, 1.0, work)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rf = {e["name"]: e for e in events if e.get("ph") == "X"
          and e.get("name", "").startswith("probe.rf")}
    probes = [e for e in events if e.get("cat") == "dawn"
              and e["name"] == "probe"]
    assert len(probes) == 10 and len(rf) == 10
    same = [p for p in probes if took[p["args"]["i"]] < 1_000_000]
    assert len(same) >= 5
    for p in same:
        r = rf[f"probe.rf{p['args']['i']}"]
        assert abs(p["ts"] - r["ts"]) < 1000
        assert abs((p["ts"] + p["dur"]) - (r["ts"] + r["dur"])) < 1000


def test_timer_count_keeps_counting_past_its_samples():
    m = Metrics()
    for _ in range(2500):
        m.observe("x", 0.002)
    m.inc("c", 0.5)
    m.inc_many({"c": 0.25, "d": 3})
    m.gauge("g", 2)
    m.gauge("g", 4)
    snap = m.snapshot()
    assert snap["x_count"] == 2500
    assert snap["x_p50_ms"] == pytest.approx(2.0)
    assert (snap["c"], snap["d"], snap["g"]) == (0.75, 3, 4)


# -- a CPU node ingesting a WARC file with one extraction worker ----------

VOCAB, H, NH, I, L, P = 512, 128, 2, 512, 1, 64
WORDS = ["lighthouse", "harbour", "keeper", "storm", "ship", "rock", "light",
         "coast", "night", "sea", "village", "bell", "fog", "wave", "island",
         "rope", "lamp", "tower", "boat", "sailor", "the", "of", "and", "a",
         "to", "in", "is", "was", "it", "for"]
PAGES = 3000


def _checkpoint(model_dir: str, texts: list[str]) -> None:
    rng = np.random.default_rng(5)

    def w(*shape):
        return rng.standard_normal(shape, np.float32) * 0.05

    def v(*shape, base=0.0):
        return (base + rng.standard_normal(shape, np.float32) * 0.1
                ).astype(np.float32)
    tree = {"embeddings": {"word": w(VOCAB, H), "position": w(P, H),
                           "token_type": w(2, H), "ln_scale": v(H, base=1.0),
                           "ln_bias": v(H)},
            "layers": {"qkv_w": w(L, H, 3 * H), "qkv_b": v(L, 3 * H),
                       "attn_out_w": w(L, H, H), "attn_out_b": v(L, H),
                       "attn_ln_scale": v(L, H, base=1.0),
                       "attn_ln_bias": v(L, H), "ffn_in_w": w(L, H, I),
                       "ffn_in_b": v(L, I), "ffn_out_w": w(L, I, H),
                       "ffn_out_b": v(L, H),
                       "ffn_ln_scale": v(L, H, base=1.0),
                       "ffn_ln_bias": v(L, H)}}
    os.makedirs(model_dir)
    save_safetensors(params_from_numpy(tree),
                     os.path.join(model_dir, "model.safetensors"),
                     BertConfig(vocab_size=VOCAB, hidden_size=H, num_layers=L,
                                num_heads=NH, intermediate_size=I,
                                max_position_embeddings=P))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "hidden_act": "gelu",
                   "hidden_size": H, "num_hidden_layers": L,
                   "num_attention_heads": NH, "intermediate_size": I,
                   "vocab_size": VOCAB, "max_position_embeddings": P,
                   "pad_token_id": 0}, f)
    vocab = build_vocab_from_corpus(texts, size=VOCAB)
    with open(os.path.join(model_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(sorted(vocab, key=vocab.get)) + "\n")


def _wait(pred, timeout: float = 120.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture(scope="module")
def ingest_run(tmp_path_factory):
    """A node ingesting PAGES pages (a twelfth of them with too little text
    to keep) through one extraction worker, captured for its first 4 s:
    (node pid, the trace's dawn spans, the rise of /api/metrics while the
    file went in (its counters are the process's, which other tests in
    this process also move), the gauge ingest_workers, pages stored)."""
    tmp = tmp_path_factory.mktemp("trace_ingest")
    rng = np.random.default_rng(3)
    records, texts = [], []
    script = "<script>var x = 1;</script>" * 30  # no text, 810 bytes
    for i in range(PAGES):
        n = 20 if i % 12 == 0 else int(rng.integers(100, 160))
        text = f"{WORDS[i % 20]} {i} " + " ".join(rng.choice(WORDS, n))
        texts.append(text)
        records.append((f"https://trace.example/{i}",
                        (f"<html><head><title>Page {i}</title>{script}"
                         f"</head><body><article><p>{text}</p></article>"
                         f"</body></html>").encode()))
    path = str(tmp / "crawl.warc.gz")
    warc.write_warc(path, records)
    model_dir = str(tmp / "model")
    _checkpoint(model_dir, texts[:200])
    before = METRICS.snapshot()
    node = DawnNode(Config(
        device="cpu", data_dir=str(tmp / "data"), web=True,
        web_listen_address="127.0.0.1:0", index_cc=True, warc_source=path,
        ingest_workers=1, ingest_batch_size=32, model_dir=model_dir,
        seq_buckets=(32, 64), index_capacity=8192)).start()
    try:
        base = f"http://127.0.0.1:{node.http_port}"
        # from before the worker's first record (it takes a second to
        # spawn) into the inserts
        with urllib.request.urlopen(base + "/api/profile?seconds=4",
                                    timeout=120) as r:
            trace = json.loads(r.read())["trace"]
        assert _wait(lambda: node.extractor.ledger.seen(path))
        with urllib.request.urlopen(base + "/api/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        rise = {k: v - before.get(k, 0) for k, v in metrics.items()}
        yield (os.getpid(), _dawn(trace), rise, metrics["ingest_workers"],
               len(node.provider.store))
    finally:
        node.stop()


def test_insert_thread_spans_tile_a_capture(ingest_run):
    dawn = ingest_run[1]
    tids = {e["tid"] for e in dawn if e["name"] == "ingest.dispatch"}
    assert len(tids) == 1
    mine = sorted((e for e in dawn if e["tid"] in tids),
                  key=lambda e: e["ts"])
    top = [e for e in mine if e["args"]["parent_id"] is None]
    assert {"ingest.insert.wait", "ingest.screen", "ingest.dispatch",
            "ingest.readback", "ingest.store"} <= {e["name"] for e in top}
    covered, end = 0.0, top[0]["ts"]
    for e in top:  # union of the top-level spans
        s, f = max(e["ts"], end), e["ts"] + e["dur"]
        if f > s:
            covered += f - s
            end = f
    assert covered / (end - top[0]["ts"]) >= 0.98
    enc = [e for e in mine if e["name"] == "encoder.forward"]
    assert enc and all(e["args"]["parent"] == "ingest.dispatch" for e in enc)
    for e in enc:
        a = e["args"]
        assert a["S"] in (32, 64) and 0 < a["real"] <= a["B"] * a["S"]
        assert a["batches"] and all("." in b for b in a["batches"])


def test_worker_stages_reach_metrics_and_the_trace(ingest_run):
    pid, dawn, metrics, workers, stored = ingest_run
    assert workers == 1
    assert metrics["ingest_records_read"] == PAGES
    assert metrics["ingest_pages_kept"] == stored == PAGES - PAGES // 12
    for stage in ("read", "decode", "html", "filter"):
        assert metrics[f"ingest_extract_{stage}_s"] >= 0
    assert metrics["ingest_extract_html_s"] > 0
    assert metrics["ingest_extract_repaired"] == 0  # every body valid
    assert metrics["encoder_tokens_padded"] >= metrics["encoder_tokens_real"]
    assert metrics["ingest_insert_count"] > 0
    for step in ("screen", "readback", "store"):
        assert metrics[f"ingest_{step}_s"] > 0, step
    records = [e for e in dawn if e["name"] == "extract.record"]
    assert records and {e["pid"] for e in records} - {pid}
    assert all(e["pid"] != pid for e in records)
    assert any(e["args"]["kept"] for e in records)
    assert any(not e["args"]["kept"] for e in records)
    ph = {e["name"]: e["ph"] for e in dawn}
    # the other threads' waits are async pairs; the insert thread's own
    # wait, which says what it was doing, is a span
    assert ph["ingest.tokenize"] == "X" and ph["ingest.insert.wait"] == "X"
    assert ph["extract.collect.wait"] == "b"
    assert ph["ingest.tokenize.wait"] == "b"


def test_add_spans_without_a_span_keeps_the_trace_json(tmp_path):
    """A capture in which no span closed (a slow CPU node) still writes
    a trace that parses: no comma before the profiler's own events."""
    import json as _json

    from dawnsearch_tpu_torch.serving.http_service import add_spans
    path = tmp_path / "t.json"
    path.write_text('{"baseTimeNanoseconds": 1000, "traceEvents": '
                    '[{"ph": "X", "cat": "kernel", "name": "k", "ts": 1, '
                    '"dur": 2}]}')
    add_spans(str(path), [], {})
    assert len(_json.loads(path.read_text())["traceEvents"]) == 1
