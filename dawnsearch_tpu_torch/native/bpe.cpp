// Byte-level BPE tokenizer — C++ twin of
// dawnsearch_tpu_torch/models/tokenizer_bpe.py (RoBERTa family: GPT-2
// pre-tokenizer regex, byte->unicode mapping, greedy rank merges).
//
// Two exactness tricks keep this a twin rather than an approximation:
//
// 1. The GPT-2 pre-tokenizer pattern
//      's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+
//      |\s+(?!\S)|\s+
//    is hand-compiled into a scanner whose alternation order matches
//    the regex engine's, and whose \p{L}/\p{N}/\s classes come from
//    unicode_tables.h ranges generated by querying the Python `regex`
//    module itself (its Unicode tables differ from unicodedata on
//    9,568 codepoints — see gen_unicode_tables.py).
// 2. The GPT-2 byte->unicode map is a bijection, so BPE over mapped
//    characters is isomorphic to BPE over the raw UTF-8 bytes. The
//    Python wrapper (models/tokenizer_bpe_native.py) unmaps vocab and
//    merges spellings to raw bytes ONCE at construction; this file
//    never touches the mapping and works on byte strings throughout.
//
// A second scanner compiles Qwen2's Split pattern (Qwen3's tokenizer.json,
// `tokenizers` Split then ByteLevel without its regex):
//      (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}
//      | ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+
// and a template may lack the leading special ($A <|endoftext|>):
// dawn_bpe_configure picks both.
//
// C ABI (ctypes):
//   dawn_bpe_new(vocab_blob, vlen, merges_blob, mlen, unk, cls, sep)
//   dawn_bpe_configure(h, pattern (0 GPT-2, 1 Qwen2), lead (0 or 1))
//     vocab blob:  u32 n, then n x [i32 id][u32 len][bytes]
//     merges blob: u32 m, then m x [u32 la][bytes a][u32 lb][bytes b]
//                  (rank = position)
//   dawn_bpe_encode(h, text, len, max_len, out_ids, n_full) -> n ids
//     written; n_full (nullable) gets the ids of the text uncut
//   dawn_bpe_free(h)
// encode is const and thread-safe EXCEPT for the bounded internal
// cache, which is mutex-guarded.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

constexpr uint8_t kBpeL = 1, kBpeN = 2, kBpeS = 4;

// regex-module class flags for one codepoint (binary search the RLE
// segment table; surrogates and out-of-range get 0)
uint8_t bpe_class(uint32_t cp) {
  if (cp >= 0x110000) return 0;
  int lo = 0, hi = kNumBpeSeg - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) / 2;
    if (kBpeSegStart[mid] <= cp) lo = mid;
    else hi = mid - 1;
  }
  return kBpeSegFlags[lo];
}

// decode one UTF-8 codepoint; advances i. Invalid bytes -> U+FFFD
// (the Python wrapper encodes with errors="ignore", so this is a
// defensive path, and U+FFFD classifies as "other" like in Python).
uint32_t decode(const uint8_t *s, size_t len, size_t &i) {
  uint8_t b = s[i];
  if (b < 0x80) { i += 1; return b; }
  uint32_t cp; int n;
  if ((b & 0xE0) == 0xC0) { cp = b & 0x1F; n = 1; }
  else if ((b & 0xF0) == 0xE0) { cp = b & 0x0F; n = 2; }
  else if ((b & 0xF8) == 0xF0) { cp = b & 0x07; n = 3; }
  else { i += 1; return 0xFFFD; }
  for (int k = 1; k <= n; ++k) {
    if (i + k >= len || (s[i + k] & 0xC0) != 0x80) { i += 1; return 0xFFFD; }
    cp = (cp << 6) | (s[i + k] & 0x3F);
  }
  i += n + 1;
  return cp;
}

struct ByteRange { size_t begin, end; };  // one pre-token, [begin, end)

// Hand-compiled GPT-2 pre-tokenizer. Emits byte ranges of `s` in match
// order; semantics argued alternative-by-alternative in the header
// comment of models/tokenizer_bpe.py and verified by the parity tests.
void pretokenize(const uint8_t *s, size_t len, std::vector<ByteRange> &out) {
  size_t i = 0;
  while (i < len) {
    // alts 1-7: contraction suffixes (case-sensitive ASCII)
    if (s[i] == '\'') {
      size_t rem = len - i;
      static const char *kSuf[] = {"'s", "'t", "'re", "'ve", "'m", "'ll",
                                   "'d"};
      bool matched = false;
      for (const char *suf : kSuf) {
        size_t n = strlen(suf);
        if (rem >= n && memcmp(s + i, suf, n) == 0) {
          out.push_back({i, i + n});
          i += n;
          matched = true;
          break;
        }
      }
      if (matched) continue;
    }
    // alts 8-10: optional literal space, then a class run
    size_t sp = (s[i] == ' ') ? 1 : 0;
    if (i + sp < len) {
      size_t j = i + sp;
      uint32_t cp = decode(s, len, j);  // j now past the first run char
      uint8_t cls = bpe_class(cp);
      uint8_t want = 0;
      if (cls & kBpeL) want = kBpeL;
      else if (cls & kBpeN) want = kBpeN;
      else if (!(cls & kBpeS)) want = 0xFF;  // [^\s\p{L}\p{N}] run
      if (want) {
        size_t end = j;
        while (end < len) {
          size_t k = end;
          uint32_t c2 = decode(s, len, k);
          uint8_t f2 = bpe_class(c2);
          bool ok = (want == 0xFF) ? (f2 & (kBpeL | kBpeN | kBpeS)) == 0
                                   : (f2 & want) != 0;
          if (!ok) break;
          end = k;
        }
        out.push_back({i, end});
        i = end;
        continue;
      }
    }
    // alts 11-12: whitespace. Greedy \s+ with (?!\S) gives back one
    // char before a non-space (so it can attach to the next word);
    // a single whitespace before non-space falls through to plain \s+.
    size_t e = i;
    while (e < len) {
      size_t k = e;
      uint32_t c2 = decode(s, len, k);
      if (!(bpe_class(c2) & kBpeS)) break;
      e = k;
    }
    if (e == i) {  // non-space, non-L/N... only reachable at sp==1 with
      // nothing after the space: handled above by the whitespace run
      // (space IS \s). Defensive: emit the single char as "other".
      size_t k = i;
      decode(s, len, k);
      out.push_back({i, k});
      i = k;
      continue;
    }
    if (e < len) {
      // followed by non-space: back off the LAST whitespace char
      size_t last = i, scan = i;
      while (scan < e) { last = scan; decode(s, len, scan); }
      if (last > i) { out.push_back({i, last}); i = last; continue; }
      out.push_back({i, e});  // single whitespace char: plain \s+
      i = e;
    } else {
      out.push_back({i, e});  // trailing whitespace: \s+(?!\S) takes all
      i = e;
    }
  }
}

// Hand-compiled Qwen2 pre-tokenizer (the pattern in the header), each
// alternative tried in order at each position as the regex engine does.
bool is_crlf(uint32_t cp) { return cp == '\r' || cp == '\n'; }

// the end of the run of codepoints from i that `ok` accepts
template <class F>
size_t run_end(const uint8_t *s, size_t len, size_t i, F ok) {
  while (i < len) {
    size_t k = i;
    if (!ok(decode(s, len, k))) break;
    i = k;
  }
  return i;
}

void pretokenize_qwen2(const uint8_t *s, size_t len,
                       std::vector<ByteRange> &out) {
  auto letter = [](uint32_t c) { return (bpe_class(c) & kBpeL) != 0; };
  auto other = [](uint32_t c) {
    return (bpe_class(c) & (kBpeL | kBpeN | kBpeS)) == 0;
  };
  auto space = [](uint32_t c) { return (bpe_class(c) & kBpeS) != 0; };
  size_t i = 0;
  while (i < len) {
    // alt 1: a contraction, ASCII case-insensitive
    if (s[i] == '\'' && i + 1 < len) {
      static const char *kSuf[] = {"s", "t", "re", "ve", "m", "ll", "d"};
      size_t n = 0;
      for (const char *suf : kSuf) {
        size_t m = strlen(suf);
        if (i + 1 + m > len) continue;
        bool eq = true;
        for (size_t k = 0; k < m && eq; ++k)
          eq = (s[i + 1 + k] | 0x20) == (uint8_t)suf[k];
        if (eq) { n = 1 + m; break; }
      }
      if (n) { out.push_back({i, i + n}); i += n; continue; }
    }
    size_t j = i;
    const uint32_t c0 = decode(s, len, j);  // j past the first codepoint
    // alt 2: [^\r\n\p{L}\p{N}]?\p{L}+
    if (letter(c0)) {
      size_t e = run_end(s, len, j, letter);
      out.push_back({i, e});
      i = e;
      continue;
    }
    if (!is_crlf(c0) && !(bpe_class(c0) & kBpeN) && j < len) {
      size_t k = j;
      if (letter(decode(s, len, k))) {
        size_t e = run_end(s, len, k, letter);
        out.push_back({i, e});
        i = e;
        continue;
      }
    }
    // alt 3: one \p{N}
    if (bpe_class(c0) & kBpeN) { out.push_back({i, j}); i = j; continue; }
    // alt 4: ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    size_t o = i;
    if (c0 == ' ' && j < len) {
      size_t k = j;
      if (other(decode(s, len, k))) o = j;
    }
    {
      size_t k = o;
      if (k < len && other(decode(s, len, k))) {
        size_t e = run_end(s, len, o, other);
        e = run_end(s, len, e, is_crlf);
        out.push_back({i, e});
        i = e;
        continue;
      }
    }
    // c0 is whitespace. alt 5: \s*[\r\n]+ ends after the run's last
    // \r or \n
    const size_t e = run_end(s, len, i, space);
    size_t nl = 0;  // one past the last \r / \n in [i, e)
    for (size_t k = i; k < e;) {
      const uint32_t c = decode(s, len, k);
      if (is_crlf(c)) nl = k;
    }
    if (nl) { out.push_back({i, nl}); i = nl; continue; }
    // alt 6: \s+(?!\S) gives the run's last codepoint back before a
    // non-space; alt 7: \s+ takes a single one
    if (e < len) {
      size_t last = i, scan = i;
      while (scan < e) { last = scan; decode(s, len, scan); }
      if (last > i) { out.push_back({i, last}); i = last; continue; }
    }
    out.push_back({i, e});
    i = e;
  }
}

struct StringPairHash {
  size_t operator()(const std::pair<std::string, std::string> &p) const {
    std::hash<std::string> h;
    size_t a = h(p.first);
    return a ^ (h(p.second) + 0x9e3779b97f4a7c15ull + (a << 6) + (a >> 2));
  }
};

struct BpeTokenizer {
  std::unordered_map<std::string, int> vocab;  // raw-byte spelling -> id
  std::unordered_map<std::pair<std::string, std::string>, int, StringPairHash>
      ranks;
  int unk_id = 0, cls_id = 0, sep_id = 0;
  int pattern = 0;    // 0: GPT-2's pre-tokenizer, 1: Qwen2's
  bool lead = true;   // the template opens with cls_id

  mutable std::mutex cache_mu;
  mutable std::unordered_map<std::string, std::vector<int>> cache;
  static constexpr size_t kCacheMax = 65536;  // tokenizer_bpe.py bound

  // greedy merge-by-rank over one pre-token (tokenizer_bpe.py _bpe)
  void bpe(const std::string &token, std::vector<int> &ids) const {
    {
      std::lock_guard<std::mutex> g(cache_mu);
      auto it = cache.find(token);
      if (it != cache.end()) {
        ids.insert(ids.end(), it->second.begin(), it->second.end());
        return;
      }
    }
    std::vector<std::string> word;
    word.reserve(token.size());
    for (char c : token) word.emplace_back(1, c);
    while (word.size() > 1) {
      int best_rank = -1;
      size_t best_at = 0;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        auto it = ranks.find({word[i], word[i + 1]});
        if (it != ranks.end() && (best_rank < 0 || it->second < best_rank)) {
          best_rank = it->second;
          best_at = i;
        }
      }
      if (best_rank < 0) break;
      const std::string a = word[best_at], b = word[best_at + 1];
      std::vector<std::string> merged;
      merged.reserve(word.size());
      size_t i = 0;
      while (i < word.size()) {
        if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
          merged.push_back(a + b);
          i += 2;
        } else {
          merged.push_back(word[i]);
          i += 1;
        }
      }
      word.swap(merged);
    }
    std::vector<int> out;
    out.reserve(word.size());
    for (auto &piece : word) {
      auto it = vocab.find(piece);
      out.push_back(it == vocab.end() ? unk_id : it->second);
    }
    ids.insert(ids.end(), out.begin(), out.end());
    std::lock_guard<std::mutex> g(cache_mu);
    if (cache.size() < kCacheMax) cache.emplace(token, std::move(out));
  }
};

uint32_t read_u32(const uint8_t *&p) {
  uint32_t v;
  memcpy(&v, p, 4);
  p += 4;
  return v;
}

}  // namespace

extern "C" {

void *dawn_bpe_new(const uint8_t *vocab_blob, long vlen,
                   const uint8_t *merges_blob, long mlen, int32_t unk_id,
                   int32_t cls_id, int32_t sep_id) {
  auto *t = new BpeTokenizer();
  t->unk_id = unk_id;
  t->cls_id = cls_id;
  t->sep_id = sep_id;
  {
    const uint8_t *p = vocab_blob, *end = vocab_blob + vlen;
    if (end - p < 4) { delete t; return nullptr; }
    uint32_t n = read_u32(p);
    t->vocab.reserve(n * 2);
    for (uint32_t i = 0; i < n; ++i) {
      if (end - p < 8) { delete t; return nullptr; }
      int32_t id;
      memcpy(&id, p, 4);
      p += 4;
      uint32_t len = read_u32(p);
      if ((long)(end - p) < (long)len) { delete t; return nullptr; }
      t->vocab.emplace(std::string((const char *)p, len), id);
      p += len;
    }
  }
  {
    const uint8_t *p = merges_blob, *end = merges_blob + mlen;
    if (end - p < 4) { delete t; return nullptr; }
    uint32_t m = read_u32(p);
    t->ranks.reserve(m * 2);
    for (uint32_t r = 0; r < m; ++r) {
      if (end - p < 4) { delete t; return nullptr; }
      uint32_t la = read_u32(p);
      if ((long)(end - p) < (long)la + 4) { delete t; return nullptr; }
      std::string a((const char *)p, la);
      p += la;
      uint32_t lb = read_u32(p);
      if ((long)(end - p) < (long)lb) { delete t; return nullptr; }
      std::string b((const char *)p, lb);
      p += lb;
      t->ranks.emplace(std::make_pair(std::move(a), std::move(b)), (int)r);
    }
  }
  return t;
}

void dawn_bpe_configure(void *handle, int32_t pattern, int32_t lead) {
  auto *t = (BpeTokenizer *)handle;
  t->pattern = pattern;
  t->lead = lead != 0;
}

// -> ids written to out_ids: <s> pieces </s> (pieces </s> without a
// leading special), pieces capped at max_len less the specials
// (tokenizer_bpe.py encode: cap = max(max_len-2, 0)). With n_full, the
// pre-tokens past the cap are merged too, only to count them: *n_full is
// the length of the uncut ids.
long dawn_bpe_encode(void *handle, const char *text, long len, long max_len,
                     int32_t *out_ids, long *n_full) {
  auto *t = (const BpeTokenizer *)handle;
  const long lead = t->lead ? 1 : 0;
  long cap = max_len - 1 - lead > 0 ? max_len - 1 - lead : 0;
  std::vector<ByteRange> pre;
  if (t->pattern == 1)
    pretokenize_qwen2((const uint8_t *)text, (size_t)len, pre);
  else
    pretokenize((const uint8_t *)text, (size_t)len, pre);
  std::vector<int> ids;
  ids.reserve((size_t)cap + 2);
  if (lead) ids.push_back(t->cls_id);
  size_t k = 0;
  for (; k < pre.size() && (long)ids.size() - lead < cap; ++k)
    t->bpe(std::string(text + pre[k].begin, pre[k].end - pre[k].begin), ids);
  if (n_full) {
    long pieces = (long)ids.size() - lead;
    std::vector<int> rest;
    for (; k < pre.size(); ++k) {
      rest.clear();
      t->bpe(std::string(text + pre[k].begin, pre[k].end - pre[k].begin),
             rest);
      pieces += (long)rest.size();
    }
    *n_full = pieces + 1 + lead;
  }
  if ((long)ids.size() > cap + lead) ids.resize(cap + lead);
  ids.push_back(t->sep_id);
  for (size_t k = 0; k < ids.size(); ++k) out_ids[k] = ids[k];
  return (long)ids.size();
}

void dawn_bpe_free(void *handle) { delete (BpeTokenizer *)handle; }

}  // extern "C"
