"""Service-prefixed logging, metrics counters and program spans.

The reference logs with `[Service]`-prefixed println! gated by the
`debug` config int (config.rs:71; e.g. udp_service.rs:169-171) and
surfaces `pages_searched` / `servers_contacted` counters in results
(search_provider.rs:44-49, web.rs:318-323). Here: a tiny logger facade,
a thread-safe counter registry that the serving layer exposes
(`/api/metrics`), and a span recorder that an `/api/profile` capture
turns on, so the trace shows what each thread of the program was doing
beside the device's kernels.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_root = logging.getLogger("dawnsearch")
if not _root.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    _root.addHandler(_h)
    _root.setLevel(logging.INFO)


def service_logger(name: str) -> logging.Logger:
    """Logger named like the reference's [Service] prefixes."""
    return _root.getChild(name)


def set_debug(level: int) -> None:
    """Map the reference's integer debug flag to log levels."""
    _root.setLevel(logging.DEBUG if level > 0 else logging.INFO)


class Metrics:
    """Thread-safe counters, gauges and timers. Counters and each timer's
    `<name>_count` only grow, so a reader takes their deltas over a
    window; `<name>_p50_ms` and `_p99_ms` are over the timer's last 1,000
    samples."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(int)
        self._timings: dict[str, list[float]] = defaultdict(list)
        self._counts: dict[str, int] = defaultdict(int)

    def inc(self, name: str, amount: float = 1) -> None:
        with self._lock:
            self._counters[name] += amount

    def inc_many(self, amounts: dict[str, float]) -> None:
        """Several counters under one hold of the lock."""
        with self._lock:
            for name, amount in amounts.items():
                self._counters[name] += amount

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._counts[name] += 1
            buf = self._timings[name]
            buf.append(seconds)
            if len(buf) > 1000:
                del buf[: len(buf) - 1000]

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:  # copies only: the sorts run outside the lock
            out: dict = dict(self._counters)
            timings = [(name, list(buf), self._counts[name])
                       for name, buf in self._timings.items()]
        for name, buf, count in timings:
            s = sorted(buf)
            out[f"{name}_p50_ms"] = 1e3 * s[len(s) // 2]
            out[f"{name}_p99_ms"] = 1e3 * s[min(len(s) - 1, int(len(s) * 0.99))]
            out[f"{name}_count"] = count
        return out


METRICS = Metrics()


class _NullSpan:
    """What span() gives while no capture runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "events", "name", "args", "ph", "id", "parent", "t0")

    def __init__(self, rec: "SpanRecorder", events: list, name: str,
                 args: dict, ph: str):
        self.rec, self.events, self.name, self.args = rec, events, name, args
        self.ph = ph

    def __enter__(self):
        state = self.rec._state()
        self.parent = state.stack[-1] if state.stack else None
        if state.args:
            self.args = {**state.args, **self.args}
        self.id = next(self.rec._ids)
        state.stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        self.rec._state().stack.pop()
        p = self.parent
        self.rec._add(self.events, (
            self.name, os.getpid(), threading.get_native_id(), self.t0, t1,
            self.id, p.id if p else None, p.name if p else None, self.args,
            self.ph))
        return False


class SpanRecorder:
    """Named host intervals on the profiler's clock, recorded only while
    an `/api/profile` capture runs (serving/http_service.py::
    capture_profile) and written into its Chrome trace as category
    "dawn". Off, `span()` is one flag test that returns a shared no-op.
    On, each span keeps its name, pid, OS thread id (the tid the profiler
    writes), wall-clock start and end, the span that encloses it on its
    thread, and its args. At most `limit` spans a capture are kept; the
    rest count as `trace_spans_dropped`.

    A wait on another thread's work (`wait()`: a queue, a blocked put) is
    written as an async ("b"/"e") event, not an "X" one: a wait can last
    as long as a device-idle gap, and the benchmark names each gap after
    the "X" event of any thread that overlaps it most, which should be
    what the thread doing the work was in.

    Other processes (the extraction workers) record their own spans
    while a shared flag (`share`) is set, and hand them over with
    `extend`."""

    def __init__(self, limit: int = 200_000):
        self.on = False
        self.limit = limit
        self._lock = threading.Lock()
        self._events: list | None = None
        self._names: dict[tuple[int, int], str] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._shared: list = []

    def span(self, name: str, **args):
        if not self.on:
            return _NULL_SPAN
        return _Span(self, self._events, name, args, "X")

    def wait(self, name: str, **args):
        """A span over a wait, written as an async event."""
        if not self.on:
            return _NULL_SPAN
        return _Span(self, self._events, name, args, "b")

    @contextmanager
    def args(self, **args):
        """Add `args` to every span this thread opens inside the block
        (the ids of the batches or requests it works on)."""
        if not self.on:
            yield
            return
        state = self._state()
        saved = state.args
        state.args = {**saved, **args}
        try:
            yield
        finally:
            state.args = saved

    def record(self, name: str, t0_ns: int, t1_ns: int,
               tid: int | None = None, **args) -> None:
        """A wait timed by the caller, on thread `tid` (this one by
        default): one that another thread ends, such as a request's wait
        in a queue."""
        if self.on:
            self._add(self._events, (
                name, os.getpid(), tid or threading.get_native_id(), t0_ns,
                t1_ns, next(self._ids), None, None, args, "b"))

    def extend(self, pid: int, tid: int, thread: str, spans: list) -> None:
        """Spans of another process: (name, t0_ns, t1_ns, args, ph)
        tuples stamped on the wall clock, ph "X" for a span and "b" for a
        wait. Taken until the capture's trace is written, so a batch in
        flight when the capture stops still counts."""
        if self._events is None:
            return
        rows = [(name, pid, tid, t0, t1, next(self._ids), None, None, args,
                 ph) for name, t0, t1, args, ph in spans]
        with self._lock:
            events = self._events
            if events is None:
                return
            self._names[(pid, tid)] = thread
            room = max(self.limit - len(events), 0)
            if len(rows) > room:
                METRICS.inc("trace_spans_dropped", len(rows) - room)
            events.extend(rows[:room])

    def share(self, flag) -> None:
        """A flag (a multiprocessing.Event) set while a capture runs."""
        with self._lock:
            self._shared.append(flag)
            if self.on:
                flag.set()

    def unshare(self, flag) -> None:
        with self._lock:
            if flag in self._shared:
                self._shared.remove(flag)

    def start(self) -> None:
        with self._lock:
            self._events, self._names = [], {}
            self.on = True
            for flag in self._shared:
                flag.set()

    def stop(self) -> None:
        """Stop taking this process's spans; a span still open now is
        not kept (its end falls outside the capture)."""
        with self._lock:
            self.on = False
            for flag in self._shared:
                flag.clear()

    def take(self) -> tuple[list, dict]:
        """The capture's spans and the names of the other processes'
        threads; ends the capture."""
        with self._lock:
            events, self._events = self._events or [], None
            names, self._names = self._names, {}
        return events, names

    def _state(self):
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = _ThreadState()
            return state

    def _add(self, events: list, ev: tuple) -> None:
        # no lock: a thread that takes one here can stall another's span
        # for a switch interval; list.append is atomic
        if not self.on or events is not self._events:
            return
        if len(events) >= self.limit:
            METRICS.inc("trace_spans_dropped")
            return
        events.append(ev)


class _ThreadState:
    __slots__ = ("stack", "args")

    def __init__(self):
        self.stack: list[_Span] = []
        self.args: dict = {}


def chrome_events(events: list, names: dict, base_ns: int) -> list[dict]:
    """Recorded spans as Chrome trace events of category "dawn", an "X"
    event for a span and a "b"/"e" pair (id the span's) for a wait: ts =
    (wall ns - base_ns) / 1000, the profiler's clock; args keep the
    span's own, its id, and its parent's id and name. Each other
    process's threads get their "M" names."""
    out = []
    for (pid, tid), name in sorted(names.items()):
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name.split("/")[0]}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": name}})
    for name, pid, tid, t0, t1, sid, parent_id, parent, args, ph in events:
        ts = (t0 - base_ns) / 1e3
        args = {**args, "span_id": sid, "parent_id": parent_id,
                "parent": parent}
        if ph == "X":
            out.append({"ph": "X", "cat": "dawn", "name": name, "pid": pid,
                        "tid": tid, "ts": ts, "dur": (t1 - t0) / 1e3,
                        "args": args})
            continue
        out.append({"ph": "b", "cat": "dawn", "name": name, "id": sid,
                    "pid": pid, "tid": tid, "ts": ts, "args": args})
        out.append({"ph": "e", "cat": "dawn", "name": name, "id": sid,
                    "pid": pid, "tid": tid, "ts": (t1 - base_ns) / 1e3})
    return out


SPANS = SpanRecorder()
span = SPANS.span
wait_span = SPANS.wait
span_args = SPANS.args
