// C++ twin of the streaming WARC record parser + pre-filters
// (dawnsearch_tpu_torch/ingest/warc.py, itself a rebuild of
// the reference's src/search/page_source.rs:52-196). The Python parser
// was the last pure-Python stage of ingest stage 1 and held the GIL
// throughout; this twin runs the gzip inflate + header scan + filters
// under ctypes (GIL released). EXACT Python semantics — records, bytes,
// and errors — parity fuzz-tested against iter_warc_records in
// tests/test_torch_warc_native.py. A copy of dawnsearch_tpu/native/
// warc.cpp; the port builds it alone into its own library, linked with
// -lz (utils/nativelib.py), so a missing zlib cannot take the
// tokenizers' library down with it.
//
// Feed/take streaming API (works for local files AND network streams —
// the Python side reads chunks from any file-like object and feeds
// bytes here):
//
//   h = dawn_warc_new()                     parser handle
//   dawn_warc_feed(h, data, n)              append raw bytes (gz or plain,
//                                           sniffed from the first two)
//   dawn_warc_eof(h)                        no more feeds
//   k = dawn_warc_take(h, arena, cap, meta, max)
//       -> k filtered records appended into `arena`; per record 8 longs
//          in `meta`: url off/len, warc_type off/len, payload_type
//          off/len, body off/len. 0 = need more feed (or done),
//          -1 = parse error (Python raises ValueError), -2 = arena
//          smaller than one record (caller bug).
//   dawn_warc_free(h)
//
// Filter semantics mirrored byte-for-byte from warc.py:
//   - record type response|conversion            (page_source.rs:65)
//   - payload text/html or text/plain            (page_source.rs:68,
//     .wet extension; missing payload type falls back to the HTTP
//     envelope content-type, which never matches)
//   - URI stripped of <>, non-empty, no ? or #   (page_source.rs:73-75)
//   - Content-Length >= 500                      (page_source.rs:79-81)
//   - HTTP envelope stripped, body capped 250 KB, stripped body >= 500

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr long kMinBody = 500;     // warc.py MIN_BODY
constexpr long kMaxBody = 250000;  // warc.py MAX_BODY

struct Rec {  // offsets into WarcParser::buf
    size_t url_off, url_len;
    size_t wt_off, wt_len;
    size_t pt_off, pt_len;
    size_t body_off, body_len;
    size_t next_pos;  // parse position after this record
    bool pass;        // filters verdict
};

enum ParseStatus { kOk, kNeedMore, kStop, kError };

struct WarcParser {
    int mode = -1;  // -1 sniff, 0 plain, 1 gzip
    z_stream zs{};
    bool z_init = false;
    std::vector<unsigned char> sniff;  // first bytes until mode known
    std::vector<unsigned char> buf;    // inflated / plain carry
    size_t pos = 0;                    // parse offset into buf
    bool eof = false;
    bool stopped = false;  // truncated / clean end
    int err = 0;

    ~WarcParser() {
        if (z_init) inflateEnd(&zs);
    }
};

bool inflate_into(WarcParser* p, const unsigned char* data, size_t n) {
    // gzip (multi-member: inflateReset at each member boundary, like
    // Python's GzipFile / the reference's flate2 MultiGzDecoder)
    p->zs.next_in = const_cast<unsigned char*>(data);
    p->zs.avail_in = static_cast<uInt>(n);
    unsigned char out[1 << 16];
    while (p->zs.avail_in > 0) {
        p->zs.next_out = out;
        p->zs.avail_out = sizeof(out);
        int rc = inflate(&p->zs, Z_NO_FLUSH);
        if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR) {
            p->err = -1;
            return false;
        }
        size_t got = sizeof(out) - p->zs.avail_out;
        p->buf.insert(p->buf.end(), out, out + got);
        if (rc == Z_STREAM_END) {
            if (inflateReset(&p->zs) != Z_OK) {
                p->err = -1;
                return false;
            }
        } else if (rc == Z_BUF_ERROR && got == 0) {
            break;  // need more input
        }
    }
    return true;
}

inline bool is_space(unsigned char c) {
    // bytes.strip() whitespace set
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
           c == '\v';
}

void trim(const unsigned char* b, size_t& off, size_t& len) {
    while (len > 0 && is_space(b[off])) {
        ++off;
        --len;
    }
    while (len > 0 && is_space(b[off + len - 1])) --len;
}

bool key_eq(const unsigned char* b, size_t off, size_t len, const char* k) {
    // ASCII-lowered comparison (header keys of interest are ASCII)
    size_t kl = strlen(k);
    if (len != kl) return false;
    for (size_t i = 0; i < len; ++i) {
        unsigned char c = b[off + i];
        if (c >= 'A' && c <= 'Z') c += 32;
        if (c != static_cast<unsigned char>(k[i])) return false;
    }
    return true;
}

bool starts_with(const unsigned char* b, size_t off, size_t len,
                 const char* pre) {
    size_t pl = strlen(pre);
    return len >= pl && memcmp(b + off, pre, pl) == 0;
}

// Parse one record starting at p->pos. On kOk fills *rec (filters
// applied; rec->pass says keep/skip) and does NOT advance p->pos (the
// caller does, after copying out).
ParseStatus parse_one(WarcParser* p, Rec* rec) {
    const unsigned char* b = p->buf.data();
    size_t end = p->buf.size();
    size_t cur = p->pos;

    // skip inter-record blank lines (exactly "\r\n" or "\n")
    while (cur < end) {
        if (b[cur] == '\n') {
            ++cur;
        } else if (b[cur] == '\r' && cur + 1 < end && b[cur + 1] == '\n') {
            cur += 2;
        } else if (b[cur] == '\r' && cur + 1 >= end && !p->eof) {
            return kNeedMore;  // "\r" then chunk boundary: could be \r\n
        } else {
            break;
        }
    }
    if (cur >= end) return p->eof ? kStop : kNeedMore;

    // first header line must start with "WARC/" (warc.py raises)
    if (end - cur < 5 && !p->eof) return kNeedMore;
    if (!starts_with(b, cur, end - cur, "WARC/")) {
        p->err = -1;
        return kError;
    }

    // header block: lines to the blank line (or EOF — Python's
    // readline() returning b"" terminates the block the same way)
    long content_length = 0;
    bool cl_bad = false;
    size_t url_off = 0, url_len = 0, wt_off = 0, wt_len = 0;
    size_t ptid_off = 0, ptid_len = 0, ct_off = 0, ct_len = 0;
    bool have_ptid = false, have_ct = false;
    size_t line_start = cur;
    bool first = true;
    size_t body_start = end + 1;  // sentinel
    while (true) {
        const void* nl = memchr(b + line_start, '\n', end - line_start);
        size_t line_end;  // exclusive, without the \n
        size_t next;
        if (nl == nullptr) {
            if (!p->eof) return kNeedMore;
            if (line_start >= end) {  // EOF right at a line boundary
                body_start = end;
                break;
            }
            line_end = end;
            next = end;
        } else {
            line_end = static_cast<const unsigned char*>(nl) - b;
            next = line_end + 1;
        }
        size_t raw_len = line_end - line_start;  // without \n
        bool blank = raw_len == 0 ||
                     (raw_len == 1 && b[line_start] == '\r');
        if (!first && blank) {
            body_start = next;
            break;
        }
        if (!first) {
            // "k: v" split at the FIRST colon; later keys overwrite
            const void* col =
                memchr(b + line_start, ':', line_end - line_start);
            if (col != nullptr) {
                size_t coff = static_cast<const unsigned char*>(col) - b;
                size_t koff = line_start, klen = coff - line_start;
                size_t voff = coff + 1, vlen = line_end - coff - 1;
                trim(b, koff, klen);
                trim(b, voff, vlen);
                if (key_eq(b, koff, klen, "content-length")) {
                    // Python int(): optional sign + digits (value is
                    // already stripped); anything else -> ValueError
                    size_t i = voff, ve = voff + vlen;
                    bool neg = false;
                    if (i < ve && (b[i] == '+' || b[i] == '-')) {
                        neg = b[i] == '-';
                        ++i;
                    }
                    if (i >= ve) {
                        cl_bad = true;
                    } else {
                        long v = 0;
                        for (; i < ve; ++i) {
                            if (b[i] < '0' || b[i] > '9') {
                                cl_bad = true;
                                break;
                            }
                            if (v < (1L << 60)) v = v * 10 + (b[i] - '0');
                        }
                        if (!cl_bad) content_length = neg ? -v : v;
                    }
                } else if (key_eq(b, koff, klen, "warc-target-uri")) {
                    url_off = voff;
                    url_len = vlen;
                } else if (key_eq(b, koff, klen, "warc-type")) {
                    wt_off = voff;
                    wt_len = vlen;
                } else if (key_eq(b, koff, klen,
                                  "warc-identified-payload-type")) {
                    ptid_off = voff;
                    ptid_len = vlen;
                    have_ptid = true;
                } else if (key_eq(b, koff, klen, "content-type")) {
                    ct_off = voff;
                    ct_len = vlen;
                    have_ct = true;
                }
            }
        }
        first = false;
        if (next >= end && nl == nullptr) {  // consumed the EOF tail
            body_start = end;
            break;
        }
        line_start = next;
    }
    if (cl_bad) {  // warc.py: int() raises ValueError
        p->err = -1;
        return kError;
    }
    if (content_length < -1) {
        // Python: BufferedReader.read(n) raises ValueError for any
        // negative n except -1 ("read length must be non-negative
        // or -1").
        p->err = -1;
        return kError;
    }
    if (content_length == -1) {
        // Python: stream.read(-1) slurps to EOF, the record is
        // filtered (length -1 < 500) and parsing ends — net: stop.
        if (!p->eof) return kNeedMore;
        return kStop;
    }
    if (end - body_start < static_cast<size_t>(content_length)) {
        if (!p->eof) return kNeedMore;
        return kStop;  // truncated file: Python returns silently
    }

    rec->next_pos = body_start + content_length;

    // ---- filters (warc.py _pre_ok; byte-for-byte) ----
    // url = WARC-Target-URI value .strip("<>")
    while (url_len > 0 && (b[url_off] == '<' || b[url_off] == '>')) {
        ++url_off;
        --url_len;
    }
    while (url_len > 0 && (b[url_off + url_len - 1] == '<' ||
                           b[url_off + url_len - 1] == '>')) {
        --url_len;
    }
    size_t pt_off = have_ptid ? ptid_off : (have_ct ? ct_off : 0);
    size_t pt_len = have_ptid ? ptid_len : (have_ct ? ct_len : 0);

    rec->url_off = url_off;
    rec->url_len = url_len;
    rec->wt_off = wt_off;
    rec->wt_len = wt_len;
    rec->pt_off = pt_off;
    rec->pt_len = pt_len;
    rec->pass = false;

    bool type_ok = key_eq(b, wt_off, wt_len, "response") ||
                   key_eq(b, wt_off, wt_len, "conversion");
    bool payload_ok = starts_with(b, pt_off, pt_len, "text/html") ||
                      starts_with(b, pt_off, pt_len, "text/plain");
    bool url_ok = url_len > 0 &&
                  memchr(b + url_off, '?', url_len) == nullptr &&
                  memchr(b + url_off, '#', url_len) == nullptr;
    if (!(type_ok && payload_ok && url_ok && content_length >= kMinBody))
        return kOk;  // parsed, filtered out

    // strip HTTP/1.x envelope (response records), cap, re-check length
    size_t body_off = body_start;
    size_t body_len = content_length;
    if (starts_with(b, body_off, body_len, "HTTP/")) {
        // find \r\n\r\n over the WHOLE body first, then \n\n (warc.py)
        const unsigned char* base = b + body_off;
        const unsigned char* hit = nullptr;
        const unsigned char* scan = base;
        size_t left = body_len;
        while (left >= 4) {
            const unsigned char* c = static_cast<const unsigned char*>(
                memchr(scan, '\r', left - 3));
            if (c == nullptr) break;
            if (c[1] == '\n' && c[2] == '\r' && c[3] == '\n') {
                hit = c;
                break;
            }
            left -= (c - scan) + 1;
            scan = c + 1;
        }
        size_t sep = 4;
        if (hit == nullptr) {
            sep = 2;
            scan = base;
            left = body_len;
            while (left >= 2) {
                const unsigned char* c = static_cast<const unsigned char*>(
                    memchr(scan, '\n', left - 1));
                if (c == nullptr) break;
                if (c[1] == '\n') {
                    hit = c;
                    break;
                }
                left -= (c - scan) + 1;
                scan = c + 1;
            }
        }
        if (hit != nullptr) {
            size_t drop = (hit - base) + sep;
            body_off += drop;
            body_len -= drop;
        }
    }
    if (body_len > static_cast<size_t>(kMaxBody)) body_len = kMaxBody;
    if (body_len < static_cast<size_t>(kMinBody)) return kOk;  // filtered

    rec->body_off = body_off;
    rec->body_len = body_len;
    rec->pass = true;
    return kOk;
}

}  // namespace

extern "C" {

void* dawn_warc_new() { return new WarcParser(); }

void dawn_warc_free(void* h) { delete static_cast<WarcParser*>(h); }

long dawn_warc_feed(void* h, const char* data, long n) {
    auto* p = static_cast<WarcParser*>(h);
    if (p->err) return p->err;
    if (n <= 0) return 0;
    const auto* d = reinterpret_cast<const unsigned char*>(data);
    if (p->mode == -1) {
        p->sniff.insert(p->sniff.end(), d, d + n);
        if (p->sniff.size() < 2) return 0;  // decide on next feed/eof
        p->mode = (p->sniff[0] == 0x1f && p->sniff[1] == 0x8b) ? 1 : 0;
        if (p->mode == 1) {
            p->zs = {};
            if (inflateInit2(&p->zs, 16 + MAX_WBITS) != Z_OK) {
                p->err = -1;
                return p->err;
            }
            p->z_init = true;
            if (!inflate_into(p, p->sniff.data(), p->sniff.size()))
                return p->err;
        } else {
            p->buf.insert(p->buf.end(), p->sniff.begin(), p->sniff.end());
        }
        p->sniff.clear();
        p->sniff.shrink_to_fit();
        return 0;
    }
    if (p->mode == 1) {
        if (!inflate_into(p, d, n)) return p->err;
    } else {
        p->buf.insert(p->buf.end(), d, d + n);
    }
    return 0;
}

void dawn_warc_eof(void* h) {
    auto* p = static_cast<WarcParser*>(h);
    if (p->mode == -1) {  // sub-2-byte file: must be plain
        p->mode = 0;
        p->buf.insert(p->buf.end(), p->sniff.begin(), p->sniff.end());
        p->sniff.clear();
    }
    p->eof = true;
}

long dawn_warc_take(void* h, char* arena, long arena_cap, long* meta,
                    long max_recs) {
    auto* p = static_cast<WarcParser*>(h);
    if (p->err) return -1;
    if (p->stopped) return 0;
    long count = 0;
    long arena_used = 0;
    while (count < max_recs) {
        Rec rec;
        ParseStatus st = parse_one(p, &rec);
        if (st == kNeedMore) break;
        if (st == kStop) {
            p->stopped = true;
            break;
        }
        if (st == kError) {
            // deliver records already copied out first (the Python
            // generator yields them before raising); p->err is set,
            // so the NEXT take reports -1.
            if (count > 0) break;
            return -1;
        }
        if (!rec.pass) {
            p->pos = rec.next_pos;
            continue;
        }
        long need = static_cast<long>(rec.url_len + rec.wt_len +
                                      rec.pt_len + rec.body_len);
        if (arena_used + need > arena_cap) {
            if (count == 0) return -2;  // arena can't hold ONE record
            break;  // deliver what we have; record stays pending
        }
        const unsigned char* b = p->buf.data();
        long* m = meta + count * 8;
        auto put = [&](size_t off, size_t len, int slot) {
            memcpy(arena + arena_used, b + off, len);
            m[slot * 2] = arena_used;
            m[slot * 2 + 1] = static_cast<long>(len);
            arena_used += static_cast<long>(len);
        };
        put(rec.url_off, rec.url_len, 0);
        put(rec.wt_off, rec.wt_len, 1);
        put(rec.pt_off, rec.pt_len, 2);
        put(rec.body_off, rec.body_len, 3);
        p->pos = rec.next_pos;
        ++count;
    }
    // compact the carry so long streams don't grow without bound
    if (p->pos > (1 << 20) && p->pos > p->buf.size() / 2) {
        p->buf.erase(p->buf.begin(), p->buf.begin() + p->pos);
        p->pos = 0;
    }
    return count;
}

}  // extern "C"
