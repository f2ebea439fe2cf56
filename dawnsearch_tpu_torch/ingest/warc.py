"""Streaming WARC reader with the reference's record filters.

Rebuild of the reference's src/search/page_source.rs:52-196: stream a
(possibly gzipped, multi-member) WARC file, parse record headers
(Content-Length, WARC-Target-URI, WARC-Type, WARC-Identified-Payload-Type,
page_source.rs:178-193), and pre-filter:

- record type `response` or `conversion`       (page_source.rs:65)
- payload type text/html (or .wet text/plain)  (page_source.rs:68)
- URL carries no `?` or `#`                    (page_source.rs:73-75)
- body >= 500 bytes                            (page_source.rs:79-81)
- body capped at 250 KB                        (page_source.rs:87)

For `response` records the HTTP envelope is stripped before the body is
yielded. Works on plain or .gz files and on any binary file object.

Port of dawnsearch_tpu/ingest/warc.py. The filtered path
(apply_filters=True — every production caller) runs on the C++ twin when
its library builds (native/warc.cpp: zlib inflate + header scan + filters
under ctypes, GIL released; utils/nativelib.get_warc()), so stage 1 of
the ingest pipeline does not contend with the tokenizer and store
threads for the GIL. Exact parity — records, bytes, AND errors — is
fuzz-tested in tests/test_torch_warc_native.py; the pure-Python parser
below stays as the fallback AND the semantics oracle. `reader()` names
the parser a call takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gzip
import io
from typing import BinaryIO, Iterator

MIN_BODY = 500  # page_source.rs:79-81
MAX_BODY = 250_000  # page_source.rs:87
_ACCEPT_TYPES = ("response", "conversion")

USE_NATIVE = True  # test hook: False forces the pure-Python parser


@dataclasses.dataclass
class WarcRecord:
    url: str
    warc_type: str
    payload_type: str
    body: bytes  # HTTP envelope stripped, capped at MAX_BODY


def _read_headers(stream: io.BufferedReader) -> dict[str, str] | None:
    """WARC header block up to the blank line; None at EOF."""
    line = stream.readline()
    while line in (b"\r\n", b"\n"):  # inter-record padding
        line = stream.readline()
    if not line:
        return None
    if not line.startswith(b"WARC/"):
        raise ValueError(f"not a WARC record boundary: {line[:40]!r}")
    headers: dict[str, str] = {}
    while True:
        line = stream.readline()
        if line in (b"\r\n", b"\n", b""):
            return headers
        if b":" in line:
            k, _, v = line.partition(b":")
            headers[k.strip().decode("latin-1").lower()] = \
                v.strip().decode("latin-1")


def _strip_http_envelope(body: bytes) -> bytes:
    """response records embed an HTTP/1.x reply; drop its header block."""
    if body.startswith(b"HTTP/"):
        for sep in (b"\r\n\r\n", b"\n\n"):
            idx = body.find(sep)
            if idx != -1:
                return body[idx + len(sep):]
    return body


def _iter_warc_native(lib, raw) -> Iterator[WarcRecord]:
    """Drive the C++ parser (native/warc.cpp): feed 1 MiB chunks from
    any binary stream, take filtered records out of a shared arena.
    Strings decode latin-1 — byte-for-byte what the Python parser's
    header decode does."""
    ARENA = 4 << 20  # >= MAX_BODY + headers, so one record always fits
    MAXR = 256
    h = lib.dawn_warc_new()
    arena = ctypes.create_string_buffer(ARENA)
    meta = (ctypes.c_long * (8 * MAXR))()
    try:
        eof = False
        while True:
            if not eof:
                chunk = raw.read(1 << 20)
                if chunk:
                    if lib.dawn_warc_feed(h, chunk, len(chunk)) < 0:
                        raise ValueError("invalid WARC/gzip stream")
                else:
                    eof = True
                    lib.dawn_warc_eof(h)
            while True:
                n = lib.dawn_warc_take(h, arena, ARENA, meta, MAXR)
                if n < 0:
                    raise ValueError(
                        "not a WARC record boundary (native parser)"
                        if n == -1 else "native WARC arena too small")
                if n == 0:
                    break  # drained (or stopped); feed more / finish
                # one copy of the used prefix (body is the last field
                # appended per record, so the last body's end == used)
                used = meta[8 * (n - 1) + 6] + meta[8 * (n - 1) + 7]
                buf = ctypes.string_at(arena, used)
                for r in range(n):
                    m = meta[8 * r: 8 * r + 8]
                    yield WarcRecord(
                        url=buf[m[0]:m[0] + m[1]].decode("latin-1"),
                        warc_type=buf[m[2]:m[2] + m[3]].decode("latin-1"),
                        payload_type=buf[m[4]:m[4] + m[5]].decode("latin-1"),
                        body=buf[m[6]:m[6] + m[7]],
                    )
                # n < MAXR does NOT mean drained — the arena may have
                # filled with records still pending; loop until n == 0.
            if eof:
                return
    finally:
        lib.dawn_warc_free(h)


def reader() -> str:
    """The parser iter_warc_records takes for a filtered read:
    "native" (native/warc.cpp) or "python"."""
    from dawnsearch_tpu_torch.utils import nativelib
    return ("native" if USE_NATIVE and nativelib.get_warc() is not None
            else "python")


def iter_warc_records(source: str | BinaryIO,
                      apply_filters: bool = True) -> Iterator[WarcRecord]:
    """Yield filtered records from a WARC path or binary stream."""
    own = isinstance(source, str)
    raw = open(source, "rb") if own else source
    try:
        if apply_filters and USE_NATIVE:
            from dawnsearch_tpu_torch.utils import nativelib
            lib = nativelib.get_warc()
            if lib is not None:
                yield from _iter_warc_native(lib, raw)
                return
        head = raw.peek(2) if hasattr(raw, "peek") else b""
        if (own and source.endswith(".gz")) or head[:2] == b"\x1f\x8b":
            stream = io.BufferedReader(gzip.GzipFile(fileobj=raw), 1 << 24)
        else:
            stream = io.BufferedReader(raw, 1 << 24)  # 16 MiB like the
            # reference's reader (page_source.rs:58-60)
        while True:
            headers = _read_headers(stream)
            if headers is None:
                return
            length = int(headers.get("content-length", 0))
            body = stream.read(length)
            if len(body) < length:
                return  # truncated file
            rec = WarcRecord(
                url=headers.get("warc-target-uri", "").strip("<>"),
                warc_type=headers.get("warc-type", ""),
                payload_type=headers.get(
                    "warc-identified-payload-type",
                    headers.get("content-type", "")),
                body=b"",
            )
            if apply_filters and not _pre_ok(rec, length):
                continue
            body = _strip_http_envelope(body)[:MAX_BODY]
            if apply_filters and len(body) < MIN_BODY:
                continue  # page_source.rs:79-81
            rec.body = body
            yield rec
    finally:
        if own:
            raw.close()


def _pre_ok(rec: WarcRecord, length: int) -> bool:
    if rec.warc_type not in _ACCEPT_TYPES:
        return False
    # text/html is the reference filter (page_source.rs:68); text/plain
    # is a deliberate extension for .wet conversion records
    # (pre-extracted text, tests/test_ingest.py). Records with NO
    # WARC-Identified-Payload-Type fall back to the HTTP envelope's
    # content-type ("application/http; msgtype=response" for every
    # response record), which must NOT pass — it would wave images,
    # PDFs and JS into the HTML extractor (the reference skips
    # unidentified records the same way: a missing header cannot equal
    # "text/html").
    if not (rec.payload_type.startswith("text/html")
            or rec.payload_type.startswith("text/plain")):
        return False  # page_source.rs:68
    if not rec.url or "?" in rec.url or "#" in rec.url:
        return False  # page_source.rs:73-75
    return length >= MIN_BODY


def write_warc(path: str, records: list[tuple[str, bytes]],
               warc_type: str = "response",
               payload_type: str = "text/html") -> None:
    """Minimal WARC writer (fixtures + local re-export).

    Each record gets an HTTP/1.1 envelope when warc_type='response',
    mirroring what Common Crawl serves.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        for url, body in records:
            if warc_type == "response":
                body = (b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n"
                        b"\r\n" + body)
            head = (
                f"WARC/1.0\r\n"
                f"WARC-Type: {warc_type}\r\n"
                f"WARC-Target-URI: {url}\r\n"
                f"WARC-Identified-Payload-Type: {payload_type}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n"
            ).encode()
            f.write(head + body + b"\r\n\r\n")
