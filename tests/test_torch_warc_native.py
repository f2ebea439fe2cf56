"""Native WARC parser: exact parity with ingest/warc.py (the port's copy of
tests/test_warc_native.py).

The C++ twin (native/warc.cpp) replaces the last pure-Python hot stage
of the ingest pipeline (gzip inflate + header scan + filters, GIL
released). The contract is EXACT parity with the Python parser on the
filtered path — same records, same bytes, same errors — so the Python
parser doubles as the semantics oracle here: every case runs both
parsers (USE_NATIVE toggled) and compares field-for-field.
"""

import gzip
import io
import random

import pytest
import torch

from dawnsearch_tpu_torch.ingest import warc as W
from dawnsearch_tpu_torch.utils import nativelib

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _warc_library():
    """The port builds the WARC parser into its own library with g++ and
    -lz; it must build here, or the native side would go untested."""
    assert nativelib.get_warc() is not None, nativelib.build_error("warc")


def record(url=b"http://e.example/page", wtype=b"response",
           ptype=b"text/html", body=b"x" * 600, envelope=True,
           extra=(), eol=b"\r\n", length=None):
    if envelope and wtype == b"response":
        body = b"HTTP/1.1 200 OK\r\nContent-Type: text/html\r\n\r\n" + body
    hdrs = [b"WARC/1.0", b"WARC-Type: " + wtype]
    if url is not None:
        hdrs.append(b"WARC-Target-URI: " + url)
    if ptype is not None:
        hdrs.append(b"WARC-Identified-Payload-Type: " + ptype)
    hdrs.extend(extra)
    n = len(body) if length is None else length
    hdrs.append(b"Content-Length: " + str(n).encode())
    return eol.join(hdrs) + eol + eol + body + b"\r\n\r\n"


class ChunkReader(io.RawIOBase):
    """File object that returns at most `chunk` bytes per read — drives
    the native feed loop across arbitrary record boundaries."""

    def __init__(self, data, chunk):
        self.data, self.pos, self.chunk = data, 0, chunk

    def read(self, n=-1):
        n = self.chunk if n < 0 else min(n, self.chunk)
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def run(data, native, chunk=None):
    """Parse `data` with one parser; returns (records, error_repr)."""
    old = W.USE_NATIVE
    W.USE_NATIVE = native
    out, err = [], None
    try:
        src = ChunkReader(data, chunk) if chunk else \
            io.BufferedReader(io.BytesIO(data))
        for r in W.iter_warc_records(src):
            out.append((r.url, r.warc_type, r.payload_type, r.body))
    except ValueError:
        err = "ValueError"
    finally:
        W.USE_NATIVE = old
    return out, err


def check_parity(blob, chunk=None):
    py = run(blob, native=False)
    for data in (blob, gzip.compress(blob)):
        nat = run(data, native=True, chunk=chunk)
        assert nat == py, (len(py[0]), len(nat[0]), py[1], nat[1])
    return py


def test_basic_pass_and_filters():
    blob = b"".join([
        record(),                                     # pass
        record(wtype=b"request"),                     # type filter
        record(wtype=b"metadata"),                    # type filter
        record(wtype=b"conversion", envelope=False,
               ptype=b"text/plain"),                  # pass (.wet)
        record(ptype=b"application/pdf"),             # payload filter
        record(ptype=None),                           # falls back to
        # the WARC Content-Type header (absent here) -> filtered
        record(url=b"http://e.example/?q=1"),         # ? filter
        record(url=b"http://e.example/x#frag"),       # # filter
        record(url=b""),                              # empty URL
        record(url=b"<http://wrapped.example/z>"),    # <> stripped, pass
        record(body=b"y" * 100),                      # < 500 B
        record(body=b"z" * 600, envelope=False),      # response w/o
        # HTTP/ prefix: envelope strip is a no-op, still >= 500 -> pass
    ])
    recs, err = check_parity(blob)
    assert err is None
    assert [r[0] for r in recs] == [
        "http://e.example/page", "http://e.example/page",
        "http://wrapped.example/z", "http://e.example/page"]
    assert recs[1][1] == "conversion" and recs[1][2] == "text/plain"


def test_envelope_strip_and_body_cap():
    big = b"A" * (W.MAX_BODY + 40_000)
    sep_lf = b"HTTP/1.1 200 OK\nServer: x\n\n" + b"B" * 600
    crlf_late = (b"HTTP/1.1 200 OK\nEarly: \n\nnope\r\n\r\n" +
                 b"C" * 600)  # \r\n\r\n exists -> wins over earlier \n\n
    barely = b"HTTP/1.1 200 OK\r\n\r\n" + b"D" * W.MIN_BODY  # exactly min
    under = b"HTTP/1.1 200 OK\r\n\r\n" + b"E" * (W.MIN_BODY - 1)
    blob = b"".join([
        record(body=big, envelope=False),
        record(body=sep_lf, envelope=False),
        record(body=crlf_late, envelope=False),
        record(body=barely, envelope=False),
        record(body=under, envelope=False),  # post-strip < 500 -> drop
    ])
    recs, err = check_parity(blob)
    assert err is None
    assert [len(r[3]) for r in recs] == [
        W.MAX_BODY, 600, 600, W.MIN_BODY]
    assert recs[0][3] == b"A" * W.MAX_BODY
    assert recs[2][3] == b"C" * 600


def test_header_edge_cases():
    blob = b"".join([
        # later duplicate header overwrites; case-insensitive keys;
        # whitespace around key and value; latin-1 high bytes survive
        record(extra=(b"WARC-Type: response",
                      b"  warc-target-URI  :   http://dup.example/a  ",
                      b"X-Junk-No-Colon-Line",
                      b"X-Latin1: caf\xe9 \xff")),
        # lone \n line endings throughout the header block
        record(url=b"http://lf.example/b", eol=b"\n"),
        # value with a colon (split at FIRST colon only)
        record(url=b"http://colon.example/c:8080/x"),
    ])
    recs, err = check_parity(blob)
    assert err is None
    assert recs[0][0] == "http://dup.example/a"
    assert recs[1][0] == "http://lf.example/b"
    assert recs[2][0] == "http://colon.example/c:8080/x"


def test_inter_record_padding_variants():
    r = record()
    blob = r + b"\n\n\r\n" + r + b"\r\n" + r
    recs, err = check_parity(blob)
    assert err is None and len(recs) == 3


def test_truncated_body_stops_silently():
    blob = record() + record(length=10_000, body=b"short" * 20)
    recs, err = check_parity(blob)
    assert err is None and len(recs) == 1


def test_eof_inside_header_block():
    blob = record() + b"WARC/1.0\r\nWARC-Type: response"
    recs, err = check_parity(blob)
    assert err is None and len(recs) == 1


def test_bad_boundary_raises_after_good_records():
    blob = record() + b"GARBAGE not a warc record\r\n"
    py = run(blob, native=False)
    nat = run(blob, native=True)
    assert py == nat
    assert py[1] == "ValueError" and len(py[0]) == 1


def test_bad_content_length_raises():
    raw = (b"WARC/1.0\r\nWARC-Type: response\r\n"
           b"WARC-Target-URI: http://x.example/\r\n"
           b"Content-Length: nope\r\n\r\nbody")
    py = run(raw, native=False)
    nat = run(raw, native=True)
    assert py == nat == ([], "ValueError")


def test_signed_content_length():
    # "+600" parses like Python int(). Negative lengths mirror
    # BufferedReader.read(): -1 slurps to EOF (record filtered, parse
    # ends silently); any other negative raises ValueError.
    plus = (b"WARC/1.0\r\nWARC-Type: response\r\n"
            b"WARC-Target-URI: http://p.example/\r\n"
            b"WARC-Identified-Payload-Type: text/html\r\n"
            b"Content-Length: +600\r\n\r\n" + b"HTTP/1.1 200 OK\r\n\r\n"
            + b"P" * 578 + b"\r\n\r\n")
    slurp = (b"WARC/1.0\r\nWARC-Type: response\r\n"
             b"Content-Length: -1\r\n\r\nrest is swallowed")
    recs, err = check_parity(plus + slurp)
    assert err is None
    assert [r[0] for r in recs] == ["http://p.example/"]

    neg = (b"WARC/1.0\r\nWARC-Type: response\r\n"
           b"Content-Length: -5\r\n\r\n")
    recs, err = check_parity(plus + neg)
    assert err == "ValueError"
    assert [r[0] for r in recs] == ["http://p.example/"]


def test_not_gzip_not_warc_raises():
    py = run(b"\x00\x01\x02 junk that is neither", native=False)
    nat = run(b"\x00\x01\x02 junk that is neither", native=True)
    assert py == nat == ([], "ValueError")


def test_corrupt_gzip_raises():
    data = gzip.compress(record())
    corrupt = data[:30] + b"\xde\xad\xbe\xef" * 8 + data[62:]
    _, err = run(corrupt, native=True)
    assert err == "ValueError"


def test_multimember_gzip():
    a = gzip.compress(record(url=b"http://m1.example/"))
    b = gzip.compress(record(url=b"http://m2.example/"))
    for data in (a + b, a + b + gzip.compress(b"")):
        py = run(gzip.decompress(a) + gzip.decompress(b), native=False)
        nat = run(data, native=True)
        assert nat == py and len(py[0]) == 2


def test_take_pagination_over_256_records():
    # more passing records than one take() can return (MAXR=256)
    blob = b"".join(record(url=b"http://r%d.example/" % i)
                    for i in range(300))
    recs, err = check_parity(blob)
    assert err is None and len(recs) == 300
    assert recs[0][0] == "http://r0.example/"
    assert recs[299][0] == "http://r299.example/"


def test_arena_pagination_near_max_body():
    # 4 MiB arena holds ~16 records of MAX_BODY; force several refills
    blob = b"".join(record(url=b"http://big%d.example/" % i,
                           body=bytes([65 + i % 26]) * W.MAX_BODY,
                           envelope=False)
                    for i in range(40))
    recs, err = check_parity(blob)
    assert err is None and len(recs) == 40
    assert all(len(r[3]) == W.MAX_BODY for r in recs)


@pytest.mark.parametrize("chunk", [1, 3, 17, 256, 8191])
def test_tiny_feed_chunks(chunk):
    blob = b"".join([
        record(), record(eol=b"\n"), record(body=b"q" * 3000),
        record(wtype=b"request"), record(url=b"<http://w.example/>"),
    ])
    py = run(blob, native=False)
    assert run(blob, native=True, chunk=chunk) == py
    assert run(gzip.compress(blob), native=True, chunk=chunk) == py


def test_fuzz_random_records():
    rng = random.Random(1234)
    types = [b"response", b"conversion", b"request", b"resource"]
    ptypes = [b"text/html", b"text/html; charset=utf-8", b"text/plain",
              b"application/pdf", b"image/png", None]
    urls = [b"http://a.example/x", b"<http://b.example/y>",
            b"http://c.example/?q=1", b"http://d.example/p#f", b"",
            b"http://e.example/caf\xe9", None]
    for trial in range(8):
        parts = []
        for _ in range(rng.randrange(1, 60)):
            body = bytes(rng.randrange(256) for _ in range(
                rng.choice([0, 40, 499, 500, 501, 2000, 9000])))
            # avoid bodies that start mid-record like a WARC boundary
            parts.append(record(
                url=rng.choice(urls), wtype=rng.choice(types),
                ptype=rng.choice(ptypes), body=body,
                envelope=rng.random() < 0.5,
                eol=rng.choice([b"\r\n", b"\n"])))
            if rng.random() < 0.3:
                parts.append(rng.choice([b"\r\n", b"\n", b"\r\n\n"]))
        blob = b"".join(parts)
        py = run(blob, native=False)
        for data in (blob, gzip.compress(blob)):
            nat = run(data, native=True,
                      chunk=rng.choice([None, 13, 4096]))
            assert nat == py, f"trial {trial}"


def test_write_warc_roundtrip_matches_python(tmp_path):
    p = str(tmp_path / "rt.warc.gz")
    W.write_warc(p, [("http://rt.example/%d" % i, b"body " * 200)
                     for i in range(5)])
    with open(p, "rb") as f:
        blob = gzip.decompress(f.read())
    recs, err = check_parity(blob)
    assert err is None and len(recs) == 5
