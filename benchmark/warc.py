"""A WARC writer of the benchmark's own, with Common Crawl's record
layout: for each page a `request`, a `response` (an HTTP envelope and
the HTML) and a `metadata` record.

The file is a series of gzip members, as Common Crawl's are, but cut at
the pages' fillers instead of at records: each filler (texts.Pages.parts)
is a member compressed once per size and written again wherever it
recurs, so set-up compresses only the rest of each page. Readers that
take multi-member gzip (the node's do) see the same bytes as from one
stream."""

from __future__ import annotations

import zlib

HTTP = ("HTTP/1.1 200 OK\r\nDate: Tue, 05 Mar 2024 {h:02d}:{m:02d}:17 GMT\r\n"
        "Server: nginx\r\nContent-Type: text/html; charset=UTF-8\r\n"
        "Vary: Accept-Encoding\r\nCache-Control: max-age=600, public\r\n"
        "Link: <{url}>; rel=shortlink\r\nX-Powered-By: PHP/8.1.27\r\n"
        "X-Crawler-Content-Encoding: gzip\r\n"
        "X-Crawler-Content-Length: {zlen}\r\nContent-Length: {n}\r\n\r\n")
REQUEST = ("GET /{path} HTTP/1.1\r\nUser-Agent: CCBot/2.0 "
           "(https://commoncrawl.org/faq/)\r\nAccept: text/html,application/"
           "xhtml+xml,application/xml;q=0.9,*/*;q=0.8\r\nAccept-Language: "
           "en-US,en;q=0.5\r\nAccept-Encoding: br,gzip\r\nHost: {host}\r\n"
           "Connection: Keep-Alive\r\n\r\n")
METADATA = ("fetchTimeMs: {ms}\r\ncharset-detected: UTF-8\r\n"
            "languages-cld2: {{\"reliable\":true,\"text-bytes\":{tb},"
            "\"languages\":[{{\"code\":\"{lang}\",\"code-iso-639-3\":\"x\","
            "\"text-covered\":0.99}}]}}\r\n")


def _record(kind: str, url: str, rid: int, length: int, ctype: str) -> bytes:
    return (f"WARC/1.0\r\nWARC-Type: {kind}\r\nWARC-Date: 2024-03-05T10:"
            f"{rid % 60:02d}:17Z\r\nWARC-Record-ID: <urn:uuid:{rid:08x}-0000-"
            f"4000-8000-{kind[:4].encode().hex():0>12}>\r\nContent-Length: "
            f"{length}\r\nContent-Type: {ctype}\r\nWARC-Target-URI: {url}\r\n"
            + ("WARC-Identified-Payload-Type: text/html\r\n"
               if kind == "response" else "") + "\r\n").encode()


def _member(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    return c.compress(data) + c.flush()


def write(path: str, pages, ids, level: int = 1) -> int:
    """Write pages `ids` of texts.Pages `pages`. Returns the file's
    bytes."""
    members: dict[tuple, bytes] = {}
    size = 0
    with open(path, "wb") as f:
        raw = bytearray()

        def put(data: bytes) -> None:
            nonlocal size
            f.write(data)
            size += len(data)

        for i in ids:
            url = pages.url(i)
            _, _, host, path_ = url.split("/", 3)
            parts = [p.encode() if isinstance(p, str) else p
                     for p in pages.parts(i)]
            n = sum(len(p) if isinstance(p, bytes) else pages.filler_len(*p)
                    for p in parts)
            http = HTTP.format(h=i % 24, m=i % 60, url=url, zlen=n // 5,
                               n=n).encode()
            req = REQUEST.format(path=path_, host=host).encode()
            meta = METADATA.format(ms=100 + i % 900, tb=n // 20,
                                   lang=pages.language(i)).encode()
            raw += _record("request", url, 3 * i, len(req),
                           "application/http; msgtype=request") + req
            raw += b"\r\n\r\n" + _record("response", url, 3 * i + 1,
                                         len(http) + n,
                                         "application/http; msgtype=response")
            raw += http
            for p in parts:
                if isinstance(p, bytes):
                    raw += p
                    continue
                if p not in members:
                    members[p] = _member(pages.filler(*p).encode(), level)
                if raw:
                    put(_member(bytes(raw), level))
                    raw = bytearray()
                put(members[p])
            raw += b"\r\n\r\n" + _record("metadata", url, 3 * i + 2,
                                         len(meta),
                                         "application/warc-fields") + meta
            raw += b"\r\n\r\n"
        if raw:
            put(_member(bytes(raw), level))
    return size

