"""Readers of what the port records about its ingest pipeline: counters
from /api/metrics, read as deltas over the window (the extraction
workers' stage seconds, the insert thread's wait, screen, readback and
store seconds, the encoder's real and padded tokens), and its spans in
the /api/profile trace (category "dawn"). Each returns None where the
run has nothing to read: a node that keeps no such counter or span."""

from __future__ import annotations

from collections import defaultdict

from benchmark import peaks

EXTRACT_STAGES = ("ingest_extract_read_s", "ingest_extract_decode_s",
                  "ingest_extract_html_s", "ingest_extract_filter_s")


def _has(w, *names: str) -> bool:
    return w.seconds > 0 and all(n in w.m1 for n in names)


def _extract_busy_s(w) -> float:
    return sum(w.delta(n) for n in EXTRACT_STAGES)


def extract_busy(w):
    """Share of the extraction workers' time in the window spent reading,
    decoding, extracting and filtering records, in %."""
    if not _has(w, "ingest_workers", *EXTRACT_STAGES) \
            or w.m1["ingest_workers"] <= 0:
        return None
    return 100.0 * _extract_busy_s(w) / (w.m1["ingest_workers"] * w.seconds)


def extract_us_record(w):
    """Extraction workers' busy time per WARC record read, in µs."""
    if not _has(w, "ingest_records_read", *EXTRACT_STAGES):
        return None
    n = w.delta("ingest_records_read")
    return 1e6 * _extract_busy_s(w) / n if n > 0 else None


def window_share(counter: str):
    """A reader of the share of the window that the seconds counted by
    `counter` took, in %."""
    def read(w):
        if not _has(w, counter):
            return None
        return 100.0 * w.delta(counter) / w.seconds
    return read


# the insert thread: waiting for a tokenized batch; screening its URLs
# against the store (SQLite has_url); reading the embeddings back (which
# waits for their kernels); storing the pages (SQLite)
insert_wait = window_share("ingest_insert_wait_s")
insert_screen = window_share("ingest_screen_s")
insert_readback = window_share("ingest_readback_s")
insert_store = window_share("ingest_store_s")


def encoder_pad(w):
    """Share of the encoder's (B, S) token slots that held padding, over
    the window's batches, in %."""
    if not _has(w, "encoder_tokens_real", "encoder_tokens_padded"):
        return None
    padded = w.delta("encoder_tokens_padded")
    if padded <= 0:
        return None
    return 100.0 * (1.0 - w.delta("encoder_tokens_real") / padded)


def launches(trace) -> tuple[dict, dict]:
    """Runtime and driver calls by (pid, tid), and each kernel by its
    correlation id."""
    calls = defaultdict(list)
    for e in trace.host:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in e.get("args", {}):
            calls[(e.get("pid"), e.get("tid"))].append(e)
    kernels = {e["args"]["correlation"]: e for e in trace.device
               if e.get("cat") == "kernel" and "correlation" in
               e.get("args", {})}
    return calls, kernels


def span_kernels(span: dict, calls: dict, kernels: dict) -> list | None:
    """The kernels that the runtime or driver calls inside `span`, on its
    thread, launched (matched by correlation id, never by name); None
    when a launch inside it has no kernel in the trace (the span is not
    whole)."""
    t0, t1 = span["ts"], span["ts"] + span.get("dur", 0)
    out = []
    for c in calls.get((span.get("pid"), span.get("tid")), ()):
        if c["ts"] < t0 or c["ts"] + c.get("dur", 0) > t1:
            continue
        k = kernels.get(c["args"]["correlation"])
        if k is not None:
            out.append(k)
        elif "Launch" in c.get("name", ""):
            return None
    return out


def encoder_roofline(w):
    """The encoder's share of the bf16 peak over the capture's whole
    `encoder.forward` spans: Σ B × encoder_flops(S) over the device time
    of the kernels each launched, at 989 TFLOP/s, in %."""
    if w.trace is None:
        return None
    spans = [e for e in w.trace.host if e.get("cat") == "dawn"
             and e.get("name") == "encoder.forward"]
    if not spans:
        return None
    calls, kernels = launches(w.trace)
    flops = seconds = 0.0
    for s in spans:
        ks = span_kernels(s, calls, kernels)
        if not ks:
            continue
        flops += s["args"]["B"] * peaks.encoder_flops(s["args"]["S"],
                                                      w.config)
        seconds += sum(k.get("dur", 0) for k in ks) / 1e6
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peaks.BF16_FLOPS)
