// WordPiece tokenizer — C++ twin of dawnsearch_tpu_torch/models/tokenizer.py
// (BERT-uncased family: clean, lowercase+NFD-strip, punctuation split,
// CJK isolation, greedy longest-match subwords). Exact-parity Unicode
// behavior comes from unicode_tables.h, generated from Python's own
// unicodedata (see gen_unicode_tables.py) — the tables ARE the spec.
//
// Tokenization is the host-side hot loop of ingestion and of a batched
// query (the reference calls HF tokenizers from Rust,
// embedding_service.rs:101-113). A copy of dawnsearch_tpu/native/
// tokenizer.cpp; the port builds it with g++ (utils/nativelib.py).
//
// C ABI (ctypes):
//   dawn_tok_new(vocab_utf8, len)    vocab.txt contents, id = line no.
//   dawn_tok_encode(h, text, len, max_len, out_ids, n_full) -> n ids
//     written; n_full (nullable) gets the ids of the text uncut
//   dawn_tok_free(h)
// Thread-safe after construction: encode is const and reads the vocab
// map only, so one handle serves every thread.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

constexpr uint8_t kControl = 1, kSpace = 2, kPunct = 4, kCjk = 8,
                  kCased = 16;
constexpr int kMaxWordChars = 100;  // HF max_input_chars_per_word

// non-BMP CJK ranges (tables cover the BMP only)
bool is_cjk_astral(uint32_t cp) {
  return (0x20000 <= cp && cp <= 0x2A6DF) || (0x2A700 <= cp && cp <= 0x2B73F) ||
         (0x2B740 <= cp && cp <= 0x2B81F) || (0x2B820 <= cp && cp <= 0x2CEAF) ||
         (0x2F800 <= cp && cp <= 0x2FA1F);
}

uint8_t flags_of(uint32_t cp) {
  if (cp < (uint32_t)kTableSize) return kCharFlags[cp];
  if (is_cjk_astral(cp)) return kCjk;
  return 0;  // astral symbols/emoji: pass through (category So/Lo)
}

// binary search the lower+NFD-strip mapping; nullptr = maps to itself
const char *lower_map(uint32_t cp) {
  int lo = 0, hi = kNumMappings - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (kMapCp[mid] < cp) lo = mid + 1;
    else if (kMapCp[mid] > cp) hi = mid - 1;
    else return kMapStr[mid];
  }
  return nullptr;
}

// decode one UTF-8 codepoint; advances i. Invalid bytes -> U+FFFD.
uint32_t decode(const uint8_t *s, size_t len, size_t &i) {
  uint8_t b = s[i];
  if (b < 0x80) { i += 1; return b; }
  uint32_t cp; int n;
  if ((b & 0xE0) == 0xC0) { cp = b & 0x1F; n = 1; }
  else if ((b & 0xF0) == 0xE0) { cp = b & 0x0F; n = 2; }
  else if ((b & 0xF8) == 0xF0) { cp = b & 0x07; n = 3; }
  else { i += 1; return 0xFFFD; }
  if (i + n >= len + 1 && i + n > len) { i += 1; return 0xFFFD; }
  for (int k = 1; k <= n; ++k) {
    if (i + k >= len || (s[i + k] & 0xC0) != 0x80) { i += 1; return 0xFFFD; }
    cp = (cp << 6) | (s[i + k] & 0x3F);
  }
  i += n + 1;
  return cp;
}

void append_utf8(std::string &out, uint32_t cp) {
  if (cp < 0x80) out += (char)cp;
  else if (cp < 0x800) {
    out += (char)(0xC0 | (cp >> 6));
    out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += (char)(0xE0 | (cp >> 12));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  } else {
    out += (char)(0xF0 | (cp >> 18));
    out += (char)(0x80 | ((cp >> 12) & 0x3F));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  }
}

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 0, cls_id = 0, sep_id = 0;

  // basic_tokenize (tokenizer.py:46-79): clean -> split -> lower/strip
  // -> punctuation split. Words come out as (utf8, n_codepoints).
  void basic(const uint8_t *text, size_t len,
             std::vector<std::pair<std::string, int>> &words) const {
    std::string cleaned;  // pass 1: control-strip, CJK/space handling
    cleaned.reserve(len + 16);
    size_t i = 0;
    while (i < len) {
      uint32_t cp = decode(text, len, i);
      if (cp == 0 || cp == 0xFFFD) continue;
      uint8_t f = flags_of(cp);
      if (f & kControl) continue;
      if (f & kCjk) { cleaned += ' '; append_utf8(cleaned, cp); cleaned += ' '; }
      else if (f & kSpace) cleaned += ' ';
      else append_utf8(cleaned, cp);
    }
    // pass 2: whitespace split; per token lower+strip then punct split
    size_t pos = 0, clen = cleaned.size();
    const uint8_t *cs = (const uint8_t *)cleaned.data();
    std::string cur;
    int cur_cps = 0;
    auto flush = [&]() {
      if (!cur.empty()) { words.emplace_back(cur, cur_cps); cur.clear(); cur_cps = 0; }
    };
    bool prev_cased = false;
    while (pos < clen) {
      if (cs[pos] == ' ') { flush(); prev_cased = false; ++pos; continue; }
      uint32_t cp = decode(cs, clen, pos);
      // Greek capital sigma: Python's str.lower() applies the
      // Final_Sigma rule (word-final -> U+03C2). Approximate the
      // "followed by cased" test with a one-codepoint lookahead.
      if (cp == 0x3A3) {
        size_t peek = pos;
        bool next_cased = false;
        if (peek < clen && cs[peek] != ' ') {
          uint32_t ncp = decode(cs, clen, peek);
          next_cased = (flags_of(ncp) & kCased) != 0;
        }
        uint32_t lower_sigma = (prev_cased && !next_cased) ? 0x3C2 : 0x3C3;
        append_utf8(cur, lower_sigma); ++cur_cps;
        prev_cased = true;
        continue;
      }
      bool this_cased = (flags_of(cp) & kCased) != 0;
      // lowercase + NFD-strip the codepoint
      const char *mapped = (cp < (uint32_t)kTableSize) ? lower_map(cp) : nullptr;
      if (mapped) {
        // mapped may be multiple codepoints or empty (stripped mark)
        size_t mlen = strlen(mapped), mi = 0;
        const uint8_t *ms = (const uint8_t *)mapped;
        while (mi < mlen) {
          uint32_t mcp = decode(ms, mlen, mi);
          if (flags_of(mcp) & kPunct) {
            flush();
            std::string p; append_utf8(p, mcp);
            words.emplace_back(p, 1);
          } else { append_utf8(cur, mcp); ++cur_cps; }
        }
      } else if (flags_of(cp) & kPunct) {
        flush();
        std::string p; append_utf8(p, cp);
        words.emplace_back(p, 1);
      } else { append_utf8(cur, cp); ++cur_cps; }
      prev_cased = this_cased;
    }
    flush();
  }

  // greedy longest-match (tokenizer.py _wordpiece:107-128)
  void wordpiece(const std::string &word, int n_cps,
                 std::vector<int> &ids) const {
    if (n_cps > kMaxWordChars) { ids.push_back(unk_id); return; }
    // codepoint boundaries
    std::vector<size_t> bounds;
    const uint8_t *s = (const uint8_t *)word.data();
    size_t len = word.size(), i = 0;
    bounds.push_back(0);
    while (i < len) { decode(s, len, i); bounds.push_back(i); }
    size_t nb = bounds.size() - 1;  // n codepoints
    std::vector<int> out;
    size_t start = 0;
    while (start < nb) {
      int found = -1;
      size_t end = nb;
      for (; end > start; --end) {
        std::string piece;
        if (start > 0) piece = "##";
        piece.append(word, bounds[start], bounds[end] - bounds[start]);
        auto it = vocab.find(piece);
        if (it != vocab.end()) { found = it->second; break; }
      }
      if (found < 0) { ids.push_back(unk_id); return; }  // whole word UNK
      out.push_back(found);
      start = end;
    }
    ids.insert(ids.end(), out.begin(), out.end());
  }
};

}  // namespace

extern "C" {

void *dawn_tok_new(const char *vocab_utf8, long len) {
  auto *t = new Tokenizer();
  const char *p = vocab_utf8, *end = vocab_utf8 + len;
  int id = 0;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    size_t n = nl ? (size_t)(nl - p) : (size_t)(end - p);
    while (n && (p[n - 1] == '\r' || p[n - 1] == ' ')) --n;
    if (n) t->vocab.emplace(std::string(p, n), id);
    ++id;
    if (!nl) break;
    p = nl + 1;
  }
  // Mirrors tokenizer.py's special_id so both implementations stay
  // output-identical. The MPNet vocab PREPENDS <s>/<pad>/</s>/<unk> to
  // the full BERT vocab whose body still holds literal "[CLS]"/"[SEP]",
  // so for cls/sep the first (alias) name must win when both exist;
  // [UNK] keeps BERT-first precedence (HF MPNetTokenizer's unk_token
  // IS "[UNK]").
  auto get = [&](const char *first, const char *second) {
    auto it = t->vocab.find(first);
    if (it != t->vocab.end()) return it->second;
    it = t->vocab.find(second);
    return it == t->vocab.end() ? 0 : it->second;
  };
  t->unk_id = get("[UNK]", "<unk>");
  t->cls_id = get("<s>", "[CLS]");
  t->sep_id = get("</s>", "[SEP]");
  return t;
}

// -> number of ids written to out_ids (<= max_len). [CLS] ... [SEP],
// truncated to max_len keeping the trailing [SEP] (tokenizer.py:136-141);
// *n_full, where given, the uncut length.
long dawn_tok_encode(void *handle, const char *text, long len,
                     long max_len, int32_t *out_ids, long *n_full) {
  auto *t = (Tokenizer *)handle;
  std::vector<std::pair<std::string, int>> words;
  t->basic((const uint8_t *)text, (size_t)len, words);
  std::vector<int> ids;
  ids.reserve(words.size() + 2);
  ids.push_back(t->cls_id);
  for (auto &w : words) t->wordpiece(w.first, w.second, ids);
  ids.push_back(t->sep_id);
  if (n_full) *n_full = (long)ids.size();
  if ((long)ids.size() > max_len) {
    ids.resize(max_len);
    ids[max_len - 1] = t->sep_id;
  }
  for (size_t k = 0; k < ids.size(); ++k) out_ids[k] = ids[k];
  return (long)ids.size();
}

void dawn_tok_free(void *handle) { delete (Tokenizer *)handle; }

}  // extern "C"
