"""What a run's measured window yields, for the end-to-end metrics, the
per-layer readers (metrics/*.py) and the judge."""

from __future__ import annotations

import dataclasses
import os
import threading

from benchmark.trace import Trace, load


@dataclasses.dataclass
class Window:
    t0: float                      # monotonic start and end of the window
    t1: float
    m0: dict                       # /api/metrics at t0 and t1
    m1: dict
    config: dict
    records: list = dataclasses.field(default_factory=list)
    trace: Trace | None = None
    e2e: dict = dataclasses.field(default_factory=dict)
    lines: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    flops: float | None = None     # model operations of the window's work
    rows: int = 0                  # live rows of the index
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def delta(self, name: str) -> float:
        return self.m1.get(name, 0) - self.m0.get(name, 0)


class Capture:
    """An /api/profile capture of `seconds`, started now in a thread."""

    def __init__(self, node, seconds: float):
        self.seconds = seconds
        self.path = None
        self.error = None

        def go():
            try:
                self.path = node.get(f"/api/profile?seconds={seconds}",
                                     timeout=seconds + 600)["trace"]
            except Exception as e:  # reported by result()
                self.error = e
        self._thread = threading.Thread(target=go, daemon=True)
        self._thread.start()

    def result(self) -> Trace:
        self._thread.join()
        if self.path is None:
            raise RuntimeError(f"/api/profile failed: {self.error}")
        try:
            return Trace(load(self.path), self.seconds)
        finally:
            os.remove(self.path)
