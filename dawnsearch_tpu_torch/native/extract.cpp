// Fast HTML main-content extraction — C++ twin of
// dawnsearch_tpu_torch/ingest/extract.py (same block/skip/boilerplate/anchor
// semantics, same link-density filter). The reference's extraction is
// its ingestion hot loop (readability pass, minutes per WARC file,
// the reference's src/search/page_source.rs:85,106 and
// src/index/extract.rs:86-117). The same output byte for byte as
// dawnsearch_tpu/native/extract.cpp, in one pass that allocates nothing
// per tag: a tag's name is lower-cased into a stack buffer and classified
// once, its attributes are scanned in place (an `href` is decoded only
// where links are collected), text under skipped or boilerplate elements
// is never decoded, and each block is filtered as it closes.
//
// C ABI (ctypes), each result a malloc'd buffer freed with dawn_free():
//   dawn_extract(html, len, &out_len)
//     -> title \x1E text \x1E link\n link\n ...      (html: valid UTF-8)
//   dawn_extract_page(body, len, &out_len, &repaired)
//     -> title \x1E text                             (body: any bytes)
// dawn_extract_page first drops the body's invalid UTF-8 as Python's
// bytes.decode("utf-8", errors="ignore") does, copying the body only when
// it holds some (*repaired = 1); dawn_utf8_clean(in, len, out) is that
// pass alone. Thread-safe (no globals).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

// What a tag is to the extractor, found once from its lower-cased name.
enum : unsigned {
  kSkip = 1,      // content never lives inside (script, style, head, ...)
  kBoiler = 2,    // boilerplate containers readability strips
  kBlock = 4,     // delimits text blocks
  kTitle = 8,
  kAnchor = 16,
  kRawText = 32,  // body skipped verbatim to its closing tag
};
constexpr size_t kMaxTagName = 10;  // "blockquote"
constexpr double kMaxLinkDensity = 0.5;
constexpr size_t kMinBlockChars = 20;

struct Tag {
  const char *name;
  unsigned flags;
};

template <size_t N>
unsigned find(const Tag (&tags)[N], const char *s, size_t n) {
  for (const Tag &t : tags)
    if (memcmp(t.name, s, n) == 0) return t.flags;
  return 0;
}

// s: n lower-case bytes, n <= kMaxTagName.
unsigned classify(const char *s, size_t n) {
  static const Tag k1[] = {{"p", kBlock}, {"a", kAnchor}};
  static const Tag k2[] = {{"li", kBlock}, {"td", kBlock}, {"th", kBlock},
                           {"h1", kBlock}, {"h2", kBlock}, {"h3", kBlock},
                           {"h4", kBlock}, {"h5", kBlock}, {"h6", kBlock},
                           {"br", kBlock}, {"tr", kBlock}, {"ul", kBlock},
                           {"ol", kBlock}};
  static const Tag k3[] = {{"div", kBlock}, {"pre", kBlock}, {"svg", kSkip},
                           {"nav", kBoiler}};
  static const Tag k4[] = {{"main", kBlock}, {"body", kBlock},
                           {"head", kSkip}, {"form", kBoiler}};
  static const Tag k5[] = {{"table", kBlock}, {"title", kTitle},
                           {"style", kSkip | kRawText}, {"aside", kBoiler},
                           {"label", kBoiler}};
  static const Tag k6[] = {{"script", kSkip | kRawText}, {"iframe", kSkip},
                           {"header", kBoiler}, {"footer", kBoiler},
                           {"button", kBoiler}, {"select", kBoiler},
                           {"option", kBoiler}};
  static const Tag k7[] = {{"article", kBlock}, {"section", kBlock}};
  static const Tag k8[] = {{"noscript", kSkip}, {"template", kSkip}};
  switch (n) {
    case 1: return find(k1, s, n);
    case 2: return find(k2, s, n);
    case 3: return find(k3, s, n);
    case 4: return find(k4, s, n);
    case 5: return find(k5, s, n);
    case 6: return find(k6, s, n);
    case 7: return find(k7, s, n);
    case 8: return find(k8, s, n);
    case 10: return memcmp(s, "blockquote", 10) == 0 ? kBlock : 0;
    default: return 0;
  }
}

// The C locale's isspace, isalnum and tolower (glibc's UTF-8 locales
// classify no byte above 0x7F either).
inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
inline bool is_name(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '-';
}
inline char lower(char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

void append_utf8(std::string &out, long cp) {
  if (cp < 0x80) {
    out += static_cast<char>(cp);
  } else if (cp < 0x800) {
    out += static_cast<char>(0xC0 | (cp >> 6));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += static_cast<char>(0xE0 | (cp >> 12));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else {
    out += static_cast<char>(0xF0 | (cp >> 18));
    out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  }
}

// Minimal entity decoding: the common named set + numeric refs. `ent` is
// what lies between '&' and ';', at most 10 bytes.
void append_entity(std::string &out, const char *ent, size_t n) {
  if (n == 0) { out += '&'; return; }
  if (ent[0] == '#') {
    char num[16];  // NUL-terminated for strtol, which stops at a NUL
    memcpy(num, ent, n);
    num[n] = '\0';
    long cp = (n > 1 && (num[1] == 'x' || num[1] == 'X'))
                  ? strtol(num + 2, nullptr, 16)
                  : strtol(num + 1, nullptr, 10);
    if (cp > 0 && cp <= 0x10FFFF) append_utf8(out, cp);
    return;
  }
  auto is = [&](const char *s) {
    return strlen(s) == n && memcmp(ent, s, n) == 0;
  };
  if (is("amp")) out += '&';
  else if (is("lt")) out += '<';
  else if (is("gt")) out += '>';
  else if (is("quot")) out += '"';
  else if (is("apos")) out += '\'';
  else if (is("nbsp")) out += "\xC2\xA0";
  else { out += '&'; out.append(ent, n); out += ';'; }  // unknown: literal
}

// Appends [p, end) to `out` with its entities decoded.
void decode_into(std::string &out, const char *p, const char *end) {
  while (p < end) {
    const char *amp = static_cast<const char *>(memchr(p, '&', end - p));
    if (!amp) { out.append(p, end - p); return; }
    out.append(p, amp - p);
    p = amp;
    const char *semi = p + 1;
    const char *limit = p + 12 < end ? p + 12 : end;
    while (semi < limit && *semi != ';' && *semi != '&' && !is_ws(*semi))
      ++semi;
    if (semi < limit && *semi == ';') {
      append_entity(out, p + 1, semi - p - 1);
      p = semi + 1;
    } else {
      out += '&';
      ++p;
    }
  }
}

size_t trimmed_len(const char *s, size_t n) {
  size_t b = 0, e = n;
  while (b < e && is_ws(s[b])) ++b;
  while (e > b && is_ws(s[e - 1])) --e;
  return e - b;
}

// Appends `s` to `out` with runs of whitespace collapsed and its ends
// trimmed (Python " ".join(s.split()) over ASCII whitespace).
void normalize_into(std::string &out, const std::string &s) {
  const size_t start = out.size();
  bool pending = false;
  const char *p = s.data(), *end = p + s.size();
  while (p < end) {
    const char *run = p;
    while (p < end && !is_ws(*p)) ++p;
    if (p > run) {
      if (pending) out += ' ';
      out.append(run, p - run);
    }
    while (p < end && is_ws(*p)) ++p;
    pending = out.size() > start;
  }
}

struct Extractor {
  explicit Extractor(bool collect_links) : collect_links(collect_links) {}

  const bool collect_links;
  std::string text;   // kept blocks, '\n'-joined
  std::string buf;    // the open block's data runs, ' '-joined
  std::string title;
  std::string links;  // '\n'-joined
  size_t n_links = 0;
  size_t link_chars = 0;
  int skip_depth = 0, boiler_depth = 0, anchor_depth = 0;
  bool in_title = false;

  // Closes the open block: kept unless under kMinBlockChars or mostly
  // anchor text.
  void flush() {
    if (!buf.empty()) {
      const size_t mark = text.size();
      if (mark) text += '\n';
      const size_t start = text.size();
      normalize_into(text, buf);
      const size_t n = text.size() - start;
      if (n < kMinBlockChars ||
          static_cast<double>(link_chars) / (n ? n : 1) > kMaxLinkDensity)
        text.resize(mark);
      buf.clear();
    }
    link_chars = 0;
  }

  void data(const char *p, const char *end) {
    if (p >= end) return;
    if (in_title) { decode_into(title, p, end); return; }
    if (skip_depth || boiler_depth) return;
    const size_t mark = buf.size();
    if (mark) buf += ' ';  // data-run separator (" ".join)
    const size_t start = buf.size();
    decode_into(buf, p, end);
    const size_t n = trimmed_len(buf.data() + start, buf.size() - start);
    if (n == 0) { buf.resize(mark); return; }
    if (anchor_depth) link_chars += n;
  }

  void start_tag(unsigned flags) {
    if (flags & kTitle) in_title = true;
    if (flags & kSkip) ++skip_depth;
    else if (flags & kBoiler) ++boiler_depth;
    if (flags & kAnchor) ++anchor_depth;
    if (flags & kBlock) flush();
  }

  void end_tag(unsigned flags) {
    if (flags & kTitle) in_title = false;
    if (flags & kSkip) { if (skip_depth) --skip_depth; }
    else if (flags & kBoiler) { if (boiler_depth) --boiler_depth; }
    if ((flags & kAnchor) && anchor_depth) --anchor_depth;
    if (flags & kBlock) flush();
  }

  // An <a>'s href value [p, end), entity-decoded; empty values are not
  // links.
  void link(const char *p, const char *end) {
    const size_t mark = links.size();
    if (n_links) links += '\n';
    const size_t start = links.size();
    decode_into(links, p, end);
    if (links.size() == start) links.resize(mark);
    else ++n_links;
  }
};

// Scans a tag's attributes from `q` to its '>' (or the end), in place;
// sets *self_close on any '/' between attributes, and hands each `href`
// value to ex.link() when `hrefs`.
const char *scan_attributes(Extractor &ex, const char *q, const char *end,
                            bool hrefs, bool *self_close) {
  while (q < end && *q != '>') {
    while (q < end && is_ws(*q)) ++q;
    if (q < end && *q == '/') { *self_close = true; ++q; continue; }
    if (q >= end || *q == '>') break;
    const char *an = q;
    while (q < end && *q != '=' && *q != '>' && !is_ws(*q) && *q != '/')
      ++q;
    const bool href = hrefs && q - an == 4 && lower(an[0]) == 'h' &&
                      lower(an[1]) == 'r' && lower(an[2]) == 'e' &&
                      lower(an[3]) == 'f';
    while (q < end && is_ws(*q)) ++q;
    if (q < end && *q == '=') {
      ++q;
      while (q < end && is_ws(*q)) ++q;
      const char *vs, *ve;
      if (q < end && (*q == '"' || *q == '\'')) {
        vs = ++q;
        const char *close =
            static_cast<const char *>(memchr(q, q[-1], end - q));
        ve = q = close ? close : end;
        if (q < end) ++q;
      } else {
        vs = q;
        while (q < end && !is_ws(*q) && *q != '>') ++q;
        ve = q;
      }
      if (href) ex.link(vs, ve);
    }
  }
  return q;
}

// Parse one tag starting at '<'; returns position after '>'.
const char *parse_tag(Extractor &ex, const char *p, const char *end) {
  const char *q = p + 1;
  if (q >= end) return end;
  if (*q == '!') {  // comment / doctype / cdata
    if (end - q >= 3 && q[1] == '-' && q[2] == '-') {
      const char *close = static_cast<const char *>(
          memmem(q + 3, end - q - 3, "-->", 3));
      return close ? close + 3 : end;
    }
    const char *gt = static_cast<const char *>(memchr(q, '>', end - q));
    return gt ? gt + 1 : end;
  }
  if (*q == '?') {  // processing instruction
    const char *gt = static_cast<const char *>(memchr(q, '>', end - q));
    return gt ? gt + 1 : end;
  }
  const bool closing = (*q == '/');
  if (closing) ++q;
  const char *name_start = q;
  while (q < end && is_name(*q)) ++q;
  const size_t name_len = q - name_start;
  if (name_len == 0) {  // stray '<'
    ex.data(p, p + 1);
    return p + 1;
  }
  unsigned flags = 0;
  if (name_len <= kMaxTagName) {
    char name[kMaxTagName];
    for (size_t i = 0; i < name_len; ++i) name[i] = lower(name_start[i]);
    flags = classify(name, name_len);
  }

  bool self_close = false;
  q = scan_attributes(ex, q, end,
                      ex.collect_links && !closing && (flags & kAnchor),
                      &self_close);
  if (q < end) ++q;  // consume '>'

  if (closing) {
    ex.end_tag(flags);
    return q;
  }
  ex.start_tag(flags);
  if (self_close) {
    ex.end_tag(flags);
    return q;
  }
  if (flags & kRawText) {  // skip to the closing tag verbatim
    const size_t close_len = name_len + 2;  // "</script", "</style"
    const char *r = q;
    while (r < end) {
      r = static_cast<const char *>(memchr(r, '<', end - r));
      if (!r) return end;
      if (static_cast<size_t>(end - r) > close_len && r[1] == '/' &&
          strncasecmp(r + 2, name_start, name_len) == 0) {
        const char *gt = static_cast<const char *>(memchr(r, '>', end - r));
        ex.end_tag(flags);
        return gt ? gt + 1 : end;
      }
      ++r;
    }
    return end;
  }
  return q;
}

void run(Extractor &ex, const char *html, size_t len) {
  const char *p = html, *end = html + len;
  while (p < end) {
    const char *lt = static_cast<const char *>(memchr(p, '<', end - p));
    if (!lt) { ex.data(p, end); break; }
    ex.data(p, lt);
    p = parse_tag(ex, lt, end);
  }
  ex.flush();
}

char *result(const std::string &out, long *out_len) {
  char *ret = static_cast<char *>(malloc(out.size() + 1));
  memcpy(ret, out.data(), out.size());
  ret[out.size()] = '\0';
  if (out_len) *out_len = static_cast<long>(out.size());
  return ret;
}

// The length of the well-formed UTF-8 sequence at s[0] (Unicode's table
// 3-7), or 0 with *skip = the length of its maximal ill-formed prefix,
// which Python's decoder drops as one error.
inline size_t utf8_seq(const unsigned char *s, size_t n, size_t *skip) {
  const unsigned char b = s[0];
  size_t need;
  unsigned char lo = 0x80, hi = 0xBF;  // the second byte's range
  if (b < 0x80) return 1;
  if (b >= 0xC2 && b <= 0xDF) need = 2;
  else if (b >= 0xE0 && b <= 0xEF) {
    need = 3;
    if (b == 0xE0) lo = 0xA0;
    else if (b == 0xED) hi = 0x9F;
  } else if (b >= 0xF0 && b <= 0xF4) {
    need = 4;
    if (b == 0xF0) lo = 0x90;
    else if (b == 0xF4) hi = 0x8F;
  } else {
    *skip = 1;
    return 0;
  }
  for (size_t k = 1; k < need; ++k) {
    if (k >= n || s[k] < (k == 1 ? lo : 0x80) || s[k] > (k == 1 ? hi : 0xBF)) {
      *skip = k;
      return 0;
    }
  }
  return need;
}

// The length of the longest well-formed UTF-8 prefix of s[0, n).
size_t utf8_valid_prefix(const unsigned char *s, size_t n) {
  size_t i = 0;
  while (i < n) {
    if (i + 8 <= n) {  // eight ASCII bytes at a time
      uint64_t w;
      memcpy(&w, s + i, 8);
      if ((w & 0x8080808080808080ULL) == 0) { i += 8; continue; }
    }
    size_t skip;
    const size_t k = utf8_seq(s + i, n - i, &skip);
    if (k == 0) return i;
    i += k;
  }
  return n;
}

// Writes s[0, n) less its ill-formed bytes to `out` (room for n bytes);
// returns the bytes written.
size_t utf8_clean(const unsigned char *s, size_t n, char *out) {
  size_t w = 0, i = 0;
  while (i < n) {
    const size_t ok = utf8_valid_prefix(s + i, n - i);
    memcpy(out + w, s + i, ok);
    w += ok;
    i += ok;
    if (i < n) {
      size_t skip;
      utf8_seq(s + i, n - i, &skip);
      i += skip;
    }
  }
  return w;
}

}  // namespace

extern "C" {

// Returns malloc'd: title \x1E text \x1E links('\n'-joined). Never null.
// *out_len receives the payload byte length (the payload may contain
// embedded NULs copied from the input; callers must not strlen it).
char *dawn_extract(const char *html, long len, long *out_len) {
  Extractor ex(true);
  run(ex, html, static_cast<size_t>(len));
  std::string out;
  normalize_into(out, ex.title);
  out += '\x1E';
  out += ex.text;
  out += '\x1E';
  out += ex.links;
  return result(out, out_len);
}

// A WARC record's body, any bytes -> malloc'd: title \x1E text, as
// dawn_extract gives them for the body decoded with errors="ignore" and
// encoded again. *repaired = 1 when the body held ill-formed UTF-8.
char *dawn_extract_page(const char *body, long len, long *out_len,
                        int *repaired) {
  const auto *s = reinterpret_cast<const unsigned char *>(body);
  const size_t n = static_cast<size_t>(len);
  Extractor ex(false);
  const size_t ok = utf8_valid_prefix(s, n);
  *repaired = ok < n;
  if (ok == n) {
    run(ex, body, n);
  } else {
    std::string clean(n, '\0');
    clean.resize(utf8_clean(s, n, &clean[0]));
    run(ex, clean.data(), clean.size());
  }
  std::string out;
  out.reserve(ex.title.size() + ex.text.size() + 1);
  normalize_into(out, ex.title);
  out += '\x1E';
  out += ex.text;
  return result(out, out_len);
}

// in[0, len) less its ill-formed UTF-8 into out (room for len bytes), as
// Python's decode("utf-8", errors="ignore"); returns the bytes written.
long dawn_utf8_clean(const char *in, long len, char *out) {
  return static_cast<long>(utf8_clean(
      reinterpret_cast<const unsigned char *>(in), static_cast<size_t>(len),
      out));
}

void dawn_free(char *p) { free(p); }

}  // extern "C"
