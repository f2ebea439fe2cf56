"""Reduce a torch.profiler Chrome trace (the node's /api/profile) to the
numbers the per-layer metrics and the breakdown read: device busy time,
device time by kernel name, and the longest device-idle gaps with what
the host was doing in each."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """Times in seconds; `span` is the capture's length as asked for."""

    def __init__(self, events: list[dict], span_s: float):
        self.span = span_s
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.device = dev
        # the profiler's own span covers the whole capture: not host work
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") not in DEVICE_CATS
                     and not e.get("name", "").startswith("PyTorch Profiler")]
        starts = [e["ts"] for e in events if e.get("ph") == "X"]
        self.t0 = min(starts) if starts else 0.0
        self.busy_intervals = _union(
            [(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals) / 1e6

    def kernel_time(self, needle: str) -> tuple[int, float]:
        """(launches, seconds) of the device ops whose name holds needle."""
        hits = [e for e in self.device if needle in e.get("name", "")]
        return len(hits), sum(e.get("dur", 0) for e in hits) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The n longest gaps between device activity, each named by the
        host op (any thread) that overlaps it most."""
        b = self.busy_intervals
        gaps = sorted(((s2 - e1, e1, s2) for (_, e1), (s2, _)
                       in zip(b, b[1:])), reverse=True)[:n]
        out = []
        for length, s, e in gaps:
            best, name = 0.0, "host idle"
            for h in self.host:
                hs, he = h["ts"], h["ts"] + h.get("dur", 0)
                ov = min(he, e) - max(hs, s)
                if ov > best:
                    best, name = ov, h.get("name", "?")
            out.append([name, length / 1e6])
        return out
