"""What the per-layer readers (metrics/<name>.py) compute from a Window.
Each returns None where its run has nothing to read, and the harness then
leaves the metric out of the line."""

from __future__ import annotations

import statistics

from benchmark import peaks


def http_gap_ms(w):
    """Median over the window's answered requests of the client's latency
    from send minus the server's own `seconds`: HTTP parse, the handler
    thread, JSON and the socket, both ways."""
    gaps = [((r[4] - r[3]) - r[7]) * 1e3 for r in w.records if r[5] == 200]
    return statistics.median(gaps) if gaps else None


def query_batch(w):
    """Mean queries per text_query batch over the window."""
    b = w.delta("text_query_batches")
    return w.delta("text_query_items") / b if b > 0 else None


def timer_p50(name: str):
    def read(w):
        v = w.m1.get(f"{name}_p50_ms")
        return float(v) if v is not None else None
    return read


def mfu(w):
    """Model operations of the window's work over the window at the bf16
    peak, in %."""
    if not w.flops:
        return None
    return 100.0 * w.flops / (w.seconds * peaks.BF16_FLOPS)


def select_roofline(w):
    """K2's share of its bytes bound: the launches of `select_kernel` in
    the trace, each reading every live row's codes and scale, at the HBM
    peak, over their device time, in %."""
    if w.trace is None:
        return None
    n, t = w.trace.kernel_time("select_kernel")
    if n == 0 or t <= 0:
        return None
    need = n * peaks.select_bytes(w.rows, w.config["hidden_size"])
    return 100.0 * need / peaks.HBM_BYTES_PER_S / t


def device_idle(w):
    """Share of the traced window in which no kernel or copy ran, in %."""
    if w.trace is None or w.trace.span <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.span)
