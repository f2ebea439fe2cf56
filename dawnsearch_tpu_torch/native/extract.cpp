// Fast HTML main-content extraction — C++ twin of
// dawnsearch_tpu_torch/ingest/extract.py (same block/skip/boilerplate/anchor
// semantics, same link-density filter). The reference's extraction is
// its ingestion hot loop (readability pass, minutes per WARC file,
// the reference's src/search/page_source.rs:85,106 and
// src/index/extract.rs:86-117). A copy of dawnsearch_tpu/native/
// extract.cpp, built into the port's native library (utils/nativelib.py).
//
// C ABI (ctypes): dawn_extract(html, len, &out_len) -> malloc'd buffer
//   title \x1E text \x1E link\n link\n ...
// freed with dawn_free(). Thread-safe (no globals).

#include <cctype>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char *kSkip[] = {"script", "style", "noscript", "template",
                       "svg", "iframe", "head", nullptr};
const char *kBoiler[] = {"nav", "header", "footer", "aside", "form",
                         "button", "select", "option", "label", nullptr};
const char *kBlock[] = {"p", "div", "article", "section", "main", "li",
                        "td", "th", "blockquote", "pre", "h1", "h2", "h3",
                        "h4", "h5", "h6", "br", "tr", "ul", "ol", "table",
                        "body", nullptr};
constexpr double kMaxLinkDensity = 0.5;
constexpr size_t kMinBlockChars = 20;

bool in_list(const std::string &tag, const char **list) {
  for (int i = 0; list[i]; ++i)
    if (tag == list[i]) return true;
  return false;
}

// Minimal entity decoding: the common named set + numeric refs.
void append_entity(std::string &out, const std::string &ent) {
  if (ent.empty()) { out += '&'; return; }
  if (ent[0] == '#') {
    long cp = 0;
    if (ent.size() > 1 && (ent[1] == 'x' || ent[1] == 'X'))
      cp = strtol(ent.c_str() + 2, nullptr, 16);
    else
      cp = strtol(ent.c_str() + 1, nullptr, 10);
    if (cp <= 0 || cp > 0x10FFFF) return;
    // UTF-8 encode
    if (cp < 0x80) out += static_cast<char>(cp);
    else if (cp < 0x800) {
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
    return;
  }
  if (ent == "amp") out += '&';
  else if (ent == "lt") out += '<';
  else if (ent == "gt") out += '>';
  else if (ent == "quot") out += '"';
  else if (ent == "apos") out += '\'';
  else if (ent == "nbsp") out += "\xC2\xA0";
  else { out += '&'; out += ent; out += ';'; }  // unknown: literal
}

std::string decode_entities(const char *p, const char *end) {
  std::string out;
  out.reserve(end - p);
  while (p < end) {
    if (*p == '&') {
      const char *semi = p + 1;
      const char *limit = p + 12 < end ? p + 12 : end;
      while (semi < limit && *semi != ';' && *semi != '&' &&
             !isspace(static_cast<unsigned char>(*semi)))
        ++semi;
      if (semi < limit && *semi == ';') {
        append_entity(out, std::string(p + 1, semi));
        p = semi + 1;
        continue;
      }
    }
    out += *p++;
  }
  return out;
}

bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// collapse runs of whitespace, trim ends (Python " ".join(s.split()))
std::string normalize_ws(const std::string &s) {
  std::string out;
  out.reserve(s.size());
  bool pending = false;
  for (char c : s) {
    if (is_ws(c)) { pending = !out.empty(); continue; }
    if (pending) { out += ' '; pending = false; }
    out += c;
  }
  return out;
}

size_t trimmed_len(const std::string &s) {
  size_t b = 0, e = s.size();
  while (b < e && is_ws(s[b])) ++b;
  while (e > b && is_ws(s[e - 1])) --e;
  return e - b;
}

struct Extractor {
  std::vector<std::pair<std::string, size_t>> blocks;  // text, link_chars
  std::string buf;
  size_t link_chars = 0;
  int skip_depth = 0, boiler_depth = 0, anchor_depth = 0;
  bool in_title = false;
  std::string title;
  std::vector<std::string> links;

  void flush() {
    std::string text = normalize_ws(buf);
    if (!text.empty()) blocks.emplace_back(std::move(text), link_chars);
    buf.clear();
    link_chars = 0;
  }

  void data(const char *p, const char *end) {
    if (p >= end) return;
    std::string decoded = decode_entities(p, end);
    if (in_title) { title += decoded; return; }
    if (skip_depth || boiler_depth) return;
    if (trimmed_len(decoded) == 0) return;
    if (!buf.empty()) buf += ' ';  // data-run separator (" ".join)
    buf += decoded;
    if (anchor_depth) link_chars += trimmed_len(decoded);
  }

  void start_tag(const std::string &tag,
                 const std::vector<std::pair<std::string, std::string>> &attrs) {
    if (tag == "title") in_title = true;
    if (in_list(tag, kSkip)) ++skip_depth;
    else if (in_list(tag, kBoiler)) ++boiler_depth;
    if (tag == "a") {
      ++anchor_depth;
      for (auto &kv : attrs)
        if (kv.first == "href" && !kv.second.empty())
          links.push_back(kv.second);
    }
    if (in_list(tag, kBlock)) flush();
  }

  void end_tag(const std::string &tag) {
    if (tag == "title") in_title = false;
    if (in_list(tag, kSkip)) { if (skip_depth) --skip_depth; }
    else if (in_list(tag, kBoiler)) { if (boiler_depth) --boiler_depth; }
    if (tag == "a" && anchor_depth) --anchor_depth;
    if (in_list(tag, kBlock)) flush();
  }
};

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
  bool closing = (*q == '/');
  if (closing) ++q;
  const char *name_start = q;
  while (q < end && (isalnum(static_cast<unsigned char>(*q)) || *q == '-'))
    ++q;
  if (q == name_start) {  // stray '<'
    ex.data(p, p + 1);
    return p + 1;
  }
  std::string tag(name_start, q);
  for (auto &c : tag) c = tolower(static_cast<unsigned char>(c));

  std::vector<std::pair<std::string, std::string>> attrs;
  bool self_close = false;
  while (q < end && *q != '>') {
    while (q < end && is_ws(*q)) ++q;
    if (q < end && *q == '/') { self_close = true; ++q; continue; }
    if (q >= end || *q == '>') break;
    const char *an = q;
    while (q < end && *q != '=' && *q != '>' && !is_ws(*q) && *q != '/')
      ++q;
    std::string aname(an, q);
    for (auto &c : aname) c = tolower(static_cast<unsigned char>(c));
    while (q < end && is_ws(*q)) ++q;
    std::string aval;
    if (q < end && *q == '=') {
      ++q;
      while (q < end && is_ws(*q)) ++q;
      if (q < end && (*q == '"' || *q == '\'')) {
        char quote = *q++;
        const char *vs = q;
        while (q < end && *q != quote) ++q;
        aval = decode_entities(vs, q);
        if (q < end) ++q;
      } else {
        const char *vs = q;
        while (q < end && !is_ws(*q) && *q != '>') ++q;
        aval = decode_entities(vs, q);
      }
    }
    if (!aname.empty()) attrs.emplace_back(std::move(aname), std::move(aval));
  }
  if (q < end) ++q;  // consume '>'

  if (closing) {
    ex.end_tag(tag);
    return q;
  }
  ex.start_tag(tag, attrs);
  if (self_close) {
    ex.end_tag(tag);
    return q;
  }
  // Raw-text elements: skip to the closing tag verbatim.
  if (tag == "script" || tag == "style") {
    std::string close = "</" + tag;
    const char *r = q;
    while (r < end) {
      r = static_cast<const char *>(memchr(r, '<', end - r));
      if (!r) return end;
      if (static_cast<size_t>(end - r) > close.size() &&
          strncasecmp(r, close.c_str(), close.size()) == 0) {
        const char *gt = static_cast<const char *>(
            memchr(r, '>', end - r));
        ex.end_tag(tag);
        return gt ? gt + 1 : end;
      }
      ++r;
    }
    return end;
  }
  return q;
}

}  // namespace

extern "C" {

// Returns malloc'd: title \x1E text \x1E links('\n'-joined). Never null.
// *out_len receives the payload byte length (the payload may contain
// embedded NULs copied from the input; callers must not strlen it).
char *dawn_extract(const char *html, long len, long *out_len) {
  Extractor ex;
  const char *p = html, *end = html + len;
  while (p < end) {
    const char *lt = static_cast<const char *>(memchr(p, '<', end - p));
    if (!lt) { ex.data(p, end); break; }
    ex.data(p, lt);
    p = parse_tag(ex, lt, end);
  }
  ex.flush();

  std::string text;
  for (auto &b : ex.blocks) {
    if (b.first.size() < kMinBlockChars) continue;
    if (static_cast<double>(b.second) /
            std::max<size_t>(b.first.size(), 1) > kMaxLinkDensity)
      continue;
    if (!text.empty()) text += '\n';
    text += b.first;
  }
  std::string out = normalize_ws(ex.title);
  out += '\x1E';
  out += text;
  out += '\x1E';
  for (size_t i = 0; i < ex.links.size(); ++i) {
    if (i) out += '\n';
    out += ex.links[i];
  }
  char *ret = static_cast<char *>(malloc(out.size() + 1));
  memcpy(ret, out.data(), out.size());
  ret[out.size()] = '\0';
  if (out_len) *out_len = static_cast<long>(out.size());
  return ret;
}

void dawn_free(char *p) { free(p); }

}  // extern "C"
