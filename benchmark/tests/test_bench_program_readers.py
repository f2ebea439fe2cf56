"""The readers of what the port records about its ingest pipeline
(program_readers.py, behind metrics/*.ingest.py) on a synthetic window
and trace, None where there is nothing to read; and how a trace with
the port's waits reads: benchmark/trace.py names no gap after a wait
("b"/"e" pair), and trace_report.py pairs them."""

import json

import pytest

from benchmark import peaks, spec, trace_report
from benchmark.trace import Trace
from benchmark.window import Window

CFG = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}
COUNTERS = ("extract_busy.ingest", "extract_us_record.ingest",
            "insert_wait.ingest", "insert_screen.ingest",
            "insert_readback.ingest", "insert_store.ingest",
            "encoder_pad.ingest")


def _window(m0: dict, m1: dict, trace=None) -> Window:
    w = Window(0.0, 10.0, m0, m1, CFG)
    w.trace = trace
    return w


def _read(name: str, w):
    return spec.metric_reader(name)(w)


M0 = {"ingest_workers": 2, "ingest_extract_read_s": 1.0,
      "ingest_extract_decode_s": 0.5, "ingest_extract_html_s": 3.0,
      "ingest_extract_filter_s": 0.5, "ingest_records_read": 1000,
      "ingest_insert_wait_s": 2.0, "ingest_screen_s": 1.0,
      "ingest_readback_s": 0.5, "ingest_store_s": 4.0,
      "encoder_tokens_real": 100, "encoder_tokens_padded": 200}
M1 = {"ingest_workers": 2, "ingest_extract_read_s": 4.0,
      "ingest_extract_decode_s": 1.5, "ingest_extract_html_s": 10.0,
      "ingest_extract_filter_s": 1.5, "ingest_records_read": 25000,
      "ingest_insert_wait_s": 5.0, "ingest_screen_s": 1.5,
      "ingest_readback_s": 2.5, "ingest_store_s": 5.25,
      "encoder_tokens_real": 700, "encoder_tokens_padded": 1200}


@pytest.mark.parametrize("name,want", [
    ("extract_busy.ingest", 60.0),       # 12 s of 2 workers × 10 s
    ("extract_us_record.ingest", 500.0),  # 12 s over 24,000 records
    ("insert_wait.ingest", 30.0),
    ("insert_screen.ingest", 5.0),
    ("insert_readback.ingest", 20.0),
    ("insert_store.ingest", 12.5),
    ("encoder_pad.ingest", 40.0)])       # 600 real of 1,000 slots
def test_counter_readers_read_deltas_over_the_window(name, want):
    assert _read(name, _window(M0, M1)) == pytest.approx(want)


@pytest.mark.parametrize("name", COUNTERS + ("encoder_roofline.ingest",))
def test_readers_read_none_where_nothing_was_recorded(name):
    assert _read(name, _window({}, {})) is None


def test_a_still_window_reads_zero_or_none():
    still = _window(M1, M1)  # no record read, no batch encoded
    assert _read("extract_us_record.ingest", still) is None
    assert _read("encoder_pad.ingest", still) is None
    for name in ("extract_busy.ingest", "insert_wait.ingest",
                 "insert_screen.ingest", "insert_readback.ingest",
                 "insert_store.ingest"):
        assert _read(name, still) == 0.0, name


def _x(cat, name, ts, dur, tid=2, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def test_encoder_roofline_reads_the_kernels_each_span_launched():
    events = [
        _x("dawn", "encoder.forward", 100, 50, B=2, S=4, real=5),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=5),
        _x("cuda_runtime", "cudaMemcpyAsync", 115, 2, correlation=9),
        _x("cuda_driver", "cuLaunchKernelEx", 120, 2, correlation=6),
        # another thread's launch inside the span, and one after it
        _x("cuda_runtime", "cudaLaunchKernel", 130, 2, tid=3, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 2, correlation=8),
        # a span whose launch has no kernel in the trace: not whole
        _x("dawn", "encoder.forward", 300, 50, B=8, S=4, real=5),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 2, correlation=10),
        _x("kernel", "gemm_kernel", 150, 10, correlation=5),
        _x("gpu_memcpy", "Memcpy HtoD", 140, 5, correlation=9),
        _x("kernel", "attention_kernel", 160, 30, correlation=6),
        _x("kernel", "renamed_kernel", 170, 1000, correlation=7),
        _x("kernel", "select_kernel", 400, 1000, correlation=8)]
    w = _window({}, {}, Trace(events, 1.0))
    want = 100.0 * 2 * peaks.encoder_flops(4, CFG) / (40e-6 * peaks.BF16_FLOPS)
    assert _read("encoder_roofline.ingest", w) == pytest.approx(want)
    no_spans = [e for e in events if e["cat"] != "dawn"]
    assert _read("encoder_roofline.ingest",
                 _window({}, {}, Trace(no_spans, 1.0))) is None


def _wait(name, ts, te, tid, i):
    return [{"ph": "b", "cat": "dawn", "name": name, "id": i, "pid": 1,
             "tid": tid, "ts": ts, "args": {"span_id": i, "parent_id": None,
                                            "parent": None}},
            {"ph": "e", "cat": "dawn", "name": name, "id": i, "pid": 1,
             "tid": tid, "ts": te}]


# a 1,000 µs device-idle gap (100 to 1,100): another thread waits through
# all of it, the insert thread stores for 600 µs of it and screens for 300
GAP_EVENTS = (
    [_x("kernel", "k1", 0, 100), _x("kernel", "k2", 1100, 50)]
    + _wait("ingest.tokenize.wait", 0, 1200, 3, 90)
    + [_x("dawn", "ingest.store", 100, 600, tid=2, span_id=91,
          parent_id=None, parent=None),
       _x("dawn", "ingest.screen", 700, 300, tid=2, span_id=92,
          parent_id=None, parent=None)])


def test_a_gap_is_named_by_a_span_and_never_by_a_wait():
    gaps = Trace(GAP_EVENTS, 1.0).idle_gaps()
    assert gaps == [["ingest.store", pytest.approx(0.001)]]


def test_trace_report_reads_waits_as_spans(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": GAP_EVENTS}))
    waits = trace_report.waits(GAP_EVENTS)
    assert [(w["name"], w["ts"], w["dur"]) for w in waits] == [
        ("ingest.tokenize.wait", 0, 1200)]
    rep = trace_report.report(str(path))
    (gap,) = rep["gaps"]
    assert gap["named"] == "ingest.store"
    assert gap["threads"]["tokenize"] == {"ingest.tokenize.wait": 1.0}
    assert gap["threads"]["ingest.store"] == {"ingest.store": 0.6,
                                              "ingest.screen": 0.3}
