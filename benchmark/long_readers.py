"""Readers of ModernBERT's spans (models/modernbert.py): `encoder.attn`
around each layer's attention launch (args kind, B, S, window, theta, and
the real tokens `real` and the keys they attend to `keys`) and
`encoder.ffn` around each GeGLU FFN's two launches (B, S), children of
`encoder.forward` on the launching thread. Each share is the work's bound
(max(operations at the bf16 peak, bytes at the HBM peak)) over the device
time of the kernels the spans launched, found by correlation id
(program_readers.span_kernels), in %. Each returns None where the trace
holds no such span."""

from __future__ import annotations

from benchmark import modernbert_work as work
from benchmark import peaks
from benchmark.program_readers import launches, span_kernels


def _spans(w, name: str, **match) -> list:
    if w.trace is None:
        return []
    return [e for e in w.trace.host if e.get("cat") == "dawn"
            and e.get("name") == name
            and all(e.get("args", {}).get(k) == v for k, v in match.items())]


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def _share(w, spans: list, cost) -> float | None:
    """Σ bound of cost(span) over Σ device time of the spans' kernels."""
    if not spans:
        return None
    calls, kernels = launches(w.trace)
    need = seconds = 0.0
    for s in spans:
        ks = span_kernels(s, calls, kernels)
        if not ks:
            continue
        need += _bound(*cost(s["args"]))
        seconds += sum(k.get("dur", 0) for k in ks) / 1e6
    return 100.0 * need / seconds if seconds > 0 else None


def attn_roofline(kind: str):
    """The share of the `kind` ("global" or "local") attention launches."""
    def read(w):
        H = w.config["hidden_size"]
        spans = [s for s in _spans(w, "encoder.attn", kind=kind)
                 if "keys" in s.get("args", {})]
        return _share(w, spans, lambda a: work.attention_work(
            a["keys"], a["real"], a["B"], a["S"], H))
    return read


def geglu_roofline(w):
    """The share of the GeGLU FFNs' launches (the GeGLU and output
    projections)."""
    return _share(w, _spans(w, "encoder.ffn"),
                  lambda a: work.geglu_work(a["B"], a["S"], w.config))


def encoder_roofline(w):
    """The encoder's share of the bf16 peak over its whole encoder.forward
    spans: the projections of every (B, S) row, and each layer's attention
    over the keys its real tokens attend to (the attention skips
    padding), over the device time of the kernels each forward launched."""
    forwards = _spans(w, "encoder.forward")
    if not forwards:
        return None
    attn = [s for s in _spans(w, "encoder.attn")
            if "keys" in s.get("args", {})]
    H = w.config["hidden_size"]
    per_token = work.projection_flops(w.config)
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
            4.0 * H * s["args"]["keys"] for s in inner)
        seconds += sum(k.get("dur", 0) for k in ks) / 1e6
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * peaks.BF16_FLOPS)
