"""The yardstick's arithmetic: the FLOP count, the K2 bytes bound, a tail
taken from due times, spreads, and the reduction of a Chrome trace."""

import math

from benchmark import peaks, stats
from benchmark.trace import Trace

MINILM = {"hidden_size": 384, "intermediate_size": 1536,
          "num_hidden_layers": 6}


def test_flops_by_hand():
    # one text of 10 tokens through one 384-wide layer, counted op by op
    H, I, n = 384, 1536, 10
    qkv, out, up, down = 2 * n * H * 3 * H, 2 * n * H * H, 2 * n * H * I, \
        2 * n * I * H
    scores, mix = 2 * n * n * H, 2 * n * n * H
    one_layer = qkv + out + up + down + scores + mix
    assert peaks.encoder_flops(n, MINILM) == 6 * one_layer


def test_select_bytes():
    # 1M i8 rows of 384 codes and an f32 scale each
    assert peaks.select_bytes(1_000_000, 384) == 388_000_000
    assert abs(peaks.select_bytes(1_000_000, 384) / peaks.HBM_BYTES_PER_S
               - 115.82e-6) < 1e-8


def _latencies(stall: float) -> list[float]:
    """A server answering one request every 2 ms (FIFO) under arrivals
    every 4 ms, frozen for `stall` s at t = 1; latency from due time."""
    free, out = 0.0, []
    for j in range(1000):
        due = j * 0.004
        start = max(due, free)
        if stall and start >= 1.0 and free <= 1.0 + stall:
            start = max(start, 1.0 + stall)
        free = start + 0.002
        out.append(free - due)
    return out


def test_tail_from_due_time_counts_a_stall():
    calm, stalled = _latencies(0.0), _latencies(0.5)
    assert abs(stats.percentile(calm, 95) - 0.002) < 1e-9
    assert stats.percentile(stalled, 95) > 20 * stats.percentile(calm, 95)
    assert stats.percentile([1.0, math.inf], 95) == math.inf


def test_spread():
    assert stats.spread([1, 1, 1, 1, 1]) == 0
    assert abs(stats.spread([9, 10, 10, 10, 11]) - 0.1) < 1e-9  # 9.5, 10.5


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    ev = [_ev("kernel", "select_kernel", 0, 100),
          _ev("kernel", "gemm_kernel", 50, 100),      # overlaps the first
          _ev("gpu_memcpy", "Memcpy DtoH", 400, 100),
          _ev("kernel", "select_kernel", 800, 200),
          _ev("cpu_op", "aten::mm", 150, 250),
          _ev("python_function", "tokenize", 500, 300)]
    t = Trace(ev, span_s=0.001)
    assert abs(t.busy_s - 450e-6) < 1e-12        # [0,150) [400,500) [800,1000)
    assert abs(100 * (1 - t.busy_s / t.span) - 55.0) < 1e-9
    n, sec = t.kernel_time("select_kernel")
    assert n == 2 and abs(sec - 300e-6) < 1e-12
    assert [(k, round(v, 9)) for k, v in t.top_ops(2)] == [
        ("select_kernel", 300e-6), ("gemm_kernel", 100e-6)]
    assert [(k, round(v, 9)) for k, v in t.idle_gaps()] == [
        ("tokenize", 300e-6), ("aten::mm", 250e-6)]
