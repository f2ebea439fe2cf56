"""HTTP frontend: HTML search UI + JSON API.

Rebuild of the reference's hand-rolled HTTP/1.1 server
(the reference's src/net/http_service.rs:30-181). Same routes —
`/?q=` text search (http_service.rs:133-142), `/?s=instance:page`
more-like-this (143-154), `/robots.txt` (102-110), 404 otherwise
(112-118) — on stdlib ThreadingHTTPServer, so concurrent requests
coalesce in the embedding batcher instead of serializing. Adds a JSON
API (`/api/search`, `/api/stats`, `/api/insert`) the reference lacks;
the P2P/DCN layer and external ingesters use it.

Port of dawnsearch_tpu/serving/http_service.py. `/api/profile?seconds=N`
(loopback only, N capped at 30) captures a torch.profiler trace of the
whole process (CPU activity, and CUDA activity when torch sees a card:
every kernel launched meanwhile, from any thread) and writes it as a
Chrome trace under data_dir/profile, with the program's own spans
(utils/logging.py::SpanRecorder, category "dawn", the extraction
workers' among them) on the profiler's clock.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from dawnsearch_tpu_torch.serving import web
from dawnsearch_tpu_torch.serving.search_service import SearchService
from dawnsearch_tpu_torch.utils.logging import (METRICS, SPANS, chrome_events,
                                                service_logger)

log = service_logger("Http")

ROBOTS = "User-agent: *\nDisallow: /\n"  # http_service.rs:102-110


def _result_json(result) -> dict:
    return {
        "pages_searched": result.pages_searched,
        "instances_contacted": result.instances_contacted,
        "results": [
            {"url": p.url, "title": p.title, "text": p.text,
             "distance": p.distance, "instance_id": p.instance_id,
             "page_id": p.page_id}
            for p in result.pages
        ],
    }


MAX_INSERT_BYTES = 16 << 20  # bound /api/insert bodies (memory DoS)


def capture_profile(out_dir: str, seconds: float) -> str:
    """Profile the process for `seconds` with torch.profiler (CPU, plus
    CUDA when available) and write a Chrome trace into `out_dir`, the
    program's spans of the capture in it. Returns the trace's path;
    raises when the capture wrote nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:  # other threads' ops too (the request handlers, the batchers)
        from torch._C._profiler import _ExperimentalConfig
        extra = {"experimental_config":
                 _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):  # a torch without the option
        extra = {}
    path = os.path.join(out_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-"
                                 f"{threading.get_ident()}.json")
    try:
        with profile(activities=activities, **extra) as prof:
            SPANS.start()
            try:
                time.sleep(max(0.0, seconds))
            finally:
                SPANS.stop()
        prof.export_chrome_trace(path)
    finally:
        events, names = SPANS.take()
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"the profiler wrote no trace to {path}")
    add_spans(path, events, names)
    return path


def add_spans(path: str, events: list, names: dict) -> None:
    """Write the recorded spans into the Chrome trace at `path`, first in
    its traceEvents, on the profiler's clock: its ts is wall-clock µs
    less the file's baseTimeNanoseconds / 1000 (tests/test_torch_trace.py
    holds a span to a record_function opened with it)."""
    with open(path, "rb") as f:
        data = f.read()
    at = data.find(b'"traceEvents"')
    if at < 0:
        raise RuntimeError(f"{path} holds no traceEvents")
    start = data.index(b"[", at) + 1
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', data[:at])
    base_ns = int(m.group(1)) if m else 0
    spans = chrome_events(events, names, base_ns)
    rest = data[start:]
    # no comma before a closing bracket, nor without a span to separate
    sep = b"" if not spans or rest.lstrip().startswith(b"]") else b","
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data[:start])
        f.write(b",".join(json.dumps(e).encode() for e in spans))
        f.write(sep)
        f.write(rest)
    os.replace(tmp, path)
    log.info("profile: %d program spans", len(events))


class _Handler(BaseHTTPRequestHandler):
    service: SearchService  # set by make_server
    accept_remote_insert = False  # set by make_server (cfg.accept_insert)
    protocol_version = "HTTP/1.1"
    # Idle keep-alive connections must not pin handler threads forever
    # (ThreadingHTTPServer spawns one per connection; a client that
    # connects and goes silent would otherwise hold it indefinitely)
    timeout = 60

    def _is_local(self) -> bool:
        return self.client_address[0] in ("127.0.0.1", "::1")

    def log_message(self, fmt, *args):  # route through our logger
        log.debug("%s " + fmt, self.client_address[0], *args)

    def _send(self, code: int, body: str | bytes,
              ctype: str = "text/html; charset=utf-8") -> None:
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        if self.close_connection:
            # close_connection alone closes the socket server-side;
            # say so in the response too (keep-alive clients otherwise
            # discover the closure only on their next request)
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj), "application/json")

    def do_GET(self) -> None:  # noqa: N802
        try:
            self._route_get()
        except BrokenPipeError:
            pass
        except Exception as e:
            log.exception("request failed")
            try:
                # API clients (the JSON surface the docstring promises)
                # must get JSON errors, not an HTML error page
                if self.path.startswith("/api/"):
                    self._send_json(500, {"error": f"internal error: {e}"})
                else:
                    self._send(500, web.error_page(f"internal error: {e}"))
            except Exception:
                pass

    def _route_get(self) -> None:
        url = urlsplit(self.path)
        qs = parse_qs(url.query)
        if url.path == "/robots.txt":
            self._send(200, ROBOTS, "text/plain")
            return
        if url.path == "/api/search":
            q = qs.get("q", [""])[0]
            if not q:
                self._send_json(400, {"error": "missing q"})
                return
            t0 = time.perf_counter()
            result = self.service.text_search(q)
            out = _result_json(result)
            out["seconds"] = round(time.perf_counter() - t0, 4)
            self._send_json(200, out)
            return
        if url.path == "/api/stats":
            self._send_json(200, self.service.stats())
            return
        if url.path == "/api/metrics":
            # observability surface (SURVEY.md par.5: the reference only has
            # debug-gated prints; here counters + latency percentiles)
            self._send_json(200, METRICS.snapshot())
            return
        if url.path == "/api/profile":
            # Debug endpoint: loopback-only, and the trace directory is
            # server-chosen (under data_dir) — a remote caller must not
            # pick filesystem paths or tie up handler threads.
            if not self._is_local():
                self._send_json(403, {"error": "profile is loopback-only"})
                return
            seconds = min(float(qs.get("seconds", ["2"])[0]), 30.0)
            base = self.service.provider.data_dir or "/tmp"
            out_dir = os.path.join(base, "profile")
            try:
                path = capture_profile(out_dir, seconds)
            except Exception as e:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_json(200, {"trace_dir": out_dir, "trace": path})
            return
        if url.path != "/":
            self._send(404, web.error_page("not found"))
            return
        if "q" in qs:  # text search (http_service.rs:133-142)
            query = qs["q"][0]
            t0 = time.perf_counter()
            result = self.service.text_search(query)
            self._send(200, web.results_page(
                query, result, time.perf_counter() - t0))
            METRICS.inc("http_searches", 1)
            return
        if "s" in qs:  # more-like-this (http_service.rs:143-154)
            try:
                instance_id, page_id = qs["s"][0].rsplit(":", 1)
                page_id = int(page_id)
            except ValueError:
                self._send(400, web.error_page("bad explore link"))
                return
            t0 = time.perf_counter()
            result = self.service.more_like_search(instance_id, page_id)
            if result is None:
                self._send(404, web.error_page("page not found"))
                return
            self._send(200, web.results_page(
                f"similar to #{page_id}", result, time.perf_counter() - t0))
            return
        self._send(200, web.main_page())

    def do_POST(self) -> None:  # noqa: N802
        """POST /api/insert {"pages": [...]}; POST /api/save (on-demand
        index snapshot, reference SearchMsg::Save, search_service.rs:190).

        Write surfaces are gated like the reference's: remote inserts
        require `accept_insert` (the UDP tier's gate, config.rs:60 /
        udp_service.rs:376-394) and save is an admin op, loopback-only.
        Bodies are size-bounded — the recv path must survive hostile
        input (same bar as net/packets.decode).

        Every response sent without consuming the request body must
        close the connection: on HTTP/1.1 keep-alive the unread body
        bytes would otherwise be parsed as the next request line,
        desyncing the client."""
        try:
            path = urlsplit(self.path).path
            if path == "/api/save":
                if not self._is_local():
                    self.close_connection = True
                    self._send_json(403, {"error": "save is loopback-only"})
                    return
                self.close_connection = True  # body (if any) unread
                self.service.save()
                self._send_json(200, {"saved": True})
                return
            if path != "/api/insert":
                self.close_connection = True
                self._send_json(404, {"error": "not found"})
                return
            if not (self._is_local() or self.accept_remote_insert):
                self.close_connection = True
                self._send_json(
                    403, {"error": "node does not accept_insert"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self.close_connection = True
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length < 0:
                self.close_connection = True
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length > MAX_INSERT_BYTES:
                self.close_connection = True
                self._send_json(413, {"error": "body too large"})
                return
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
                pages = [(str(p["url"]), str(p.get("title", "")),
                          str(p.get("text", "")))
                         for p in body.get("pages", [])]
            except (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                    TypeError, AttributeError) as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            ids = self.service.insert_pages(pages)
            self._send_json(200, {"inserted": [i for i in ids if i is not None],
                                  "skipped": sum(1 for i in ids if i is None)})
        except Exception as e:
            log.exception("insert failed")
            self._send_json(500, {"error": str(e)})


def make_server(service: SearchService, listen: str = "0.0.0.0:8080",
                accept_insert: bool = False) -> ThreadingHTTPServer:
    host, _, port = listen.rpartition(":")
    handler = type("Handler", (_Handler,),
                   {"service": service, "accept_remote_insert": accept_insert})
    server = ThreadingHTTPServer((host or "0.0.0.0", int(port)), handler)
    return server


def start_http_service(service: SearchService, listen: str = "0.0.0.0:8080",
                       accept_insert: bool = False
                       ) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Serve in a daemon thread (reference spawns a tokio task,
    dawnsearch.rs:98-103). Returns (server, thread); server.shutdown()
    stops it. `accept_insert` opens /api/insert to non-loopback callers
    (the same gate the UDP tier applies to replicated inserts)."""
    server = make_server(service, listen, accept_insert=accept_insert)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="http-service")
    thread.start()
    log.info("HTTP listening on %s", listen)
    return server, thread
