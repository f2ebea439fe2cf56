"""Readers of Qwen3's spans (models/qwen3.py): `encoder.attn` (kind
"causal", B, S, heads, kv_heads, and the real tokens `real` and the keys
they attend to `keys`) around each layer's attention launch,
`encoder.ffn` (B, S) around each SwiGLU FFN's two launches and
`encoder.proj` (kind "qkv" or "out", B, S) around the QKV and output
projections, children of `encoder.forward` on the launching thread. Each
share is the work's bound (max(operations at the bf16 peak, bytes at the
HBM peak); qwen3_work counts both) over the device time of the kernels
the spans launched, found by correlation id (program_readers.
span_kernels), in %. Each returns None where the trace holds no such
span, as a program without Qwen3 gives."""

from __future__ import annotations

from benchmark import peaks
from benchmark import qwen3_work as work
from benchmark.long_readers import _share, _spans
from benchmark.program_readers import launches, span_kernels


def attn_roofline(w):
    """The share of the causal attention launches."""
    spans = [s for s in _spans(w, "encoder.attn", kind="causal")
             if "keys" in s.get("args", {})]
    return _share(w, spans, lambda a: work.attention_work(
        a["keys"], a["real"], a["B"], a["S"], w.config))


def swiglu_roofline(w):
    """The share of the SwiGLU FFNs' launches (gate/up and down)."""
    return _share(w, _spans(w, "encoder.ffn"),
                  lambda a: work.swiglu_work(a["B"], a["S"], w.config))


def proj_roofline(w):
    """The share of the QKV (with its norms and RoPE) and output (with the
    residual and the next norm's parts) projections' launches."""
    return _share(w, _spans(w, "encoder.proj"),
                  lambda a: work.proj_work(a["kind"], a["B"], a["S"],
                                           w.config))


def encoder_roofline(w):
    """The encoder's share of the bf16 peak over its whole encoder.forward
    spans: the projections of every (B, S) row and each layer's causal
    attention over the keys its real tokens attend to, over the device
    time of the kernels each forward launched."""
    forwards = _spans(w, "encoder.forward")
    if not forwards:
        return None
    attn = [s for s in _spans(w, "encoder.attn", kind="causal")
            if "keys" in s.get("args", {})]
    per_token = work.projection_flops(w.config)
    per_key = work.attention_flops_per_key(w.config)
    calls, kernels = launches(w.trace)
    flops = seconds = 0.0
    for f in forwards:
        ks = span_kernels(f, calls, kernels)
        if not ks:
            continue
        t0, t1 = f["ts"], f["ts"] + f.get("dur", 0)
        inner = [a for a in attn if a.get("tid") == f.get("tid")
                 and t0 <= a["ts"] <= t1]
        if not inner:
            continue
        a = f["args"]
        flops += a["B"] * a["S"] * per_token + sum(
            per_key * s["args"]["keys"] for s in inner)
        seconds += sum(k.get("dur", 0) for k in ks) / 1e6
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peaks.BF16_FLOPS)


def clip_to_capture(trace):
    """The trace with its device busy intervals clipped to the capture's
    span from its first event, so that the busy time (the result line's
    device.busy_s, and device_idle over it) counts the window alone. A
    device-bound pipeline still holds a dispatch or two of queued kernels
    (seconds of work here) when the capture stops; they run past its end
    and would read as more busy time than the window holds. The kernels
    themselves are kept whole for the rooflines."""
    if trace is None:
        return None
    end = trace.t0 + trace.span * 1e6
    trace.busy_intervals = [(max(s, trace.t0), min(e, end))
                            for s, e in trace.busy_intervals
                            if min(e, end) > max(s, trace.t0)]
    return trace
