// C++ twin of dawnsearch_tpu_torch/ingest/lang.py — the English-prose filter
// on the ingest hot path (rebuilds the role of whichlang at
// the reference's src/search/page_source.rs:119-121).
//
// The Python version rides C fast paths (str.split/isalpha/
// bytes.translate) but holds the GIL; this twin runs under ctypes with
// the GIL released. It must return EXACTLY the Python answers — the
// parity contract is enforced by tests/test_torch_lang_native.py over
// fixtures and seeded Unicode fuzz. A copy of dawnsearch_tpu/native/
// lang.cpp, built into the port's native library (utils/nativelib.py).
//
// Semantics mirrored (ingest/lang.py):
//   _sample        start + middle + end CODEPOINT slices, ~1024 cps
//   latin_ratio    ASCII letters vs non-ASCII chars of the sample
//   english_score  stopword fraction of letter-bearing words of the
//                  lowercased sample (str.lower -> str.split ->
//                  str.isalpha / strip(_PUNCT) / any(isalpha))
//   is_english     latin gate (0.85) then stopword gate (0.12)
//
// Unicode tables: kCharFlags carries FLAG_PYSPACE/FLAG_ALPHA for the
// BMP; kLowerCp/kLowerTo is the full-range pure str.lower() map (max
// expansion 2 cps); kAlphaHiStart/End covers isalpha above the BMP.
// All generated by gen_unicode_tables.py from Python's own unicodedata
// so the answers are Python's by construction.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "unicode_tables.h"

namespace {

constexpr uint8_t kPySpace = 32, kAlpha = 64;

// decode one UTF-8 codepoint; advances i. Input comes from CPython's
// str.encode("utf-8") so it is always valid, but stay defensive
// (same routine as tokenizer.cpp; invalid bytes -> U+FFFD).
uint32_t decode(const uint8_t *s, size_t len, size_t &i) {
  uint8_t b = s[i];
  if (b < 0x80) { i += 1; return b; }
  uint32_t cp; int n;
  if ((b & 0xE0) == 0xC0) { cp = b & 0x1F; n = 1; }
  else if ((b & 0xF0) == 0xE0) { cp = b & 0x0F; n = 2; }
  else if ((b & 0xF8) == 0xF0) { cp = b & 0x07; n = 3; }
  else { i += 1; return 0xFFFD; }
  for (int k = 1; k <= n; ++k) {
    if (i + static_cast<size_t>(k) >= len ||
        (s[i + k] & 0xC0) != 0x80) { i += 1; return 0xFFFD; }
    cp = (cp << 6) | (s[i + k] & 0x3F);
  }
  i += n + 1;
  return cp;
}

bool is_alpha(uint32_t cp) {
  if (cp < kTableSize) return kCharFlags[cp] & kAlpha;
  if (cp > 0x10FFFF) return false;
  // binary search the >BMP ranges
  int lo = 0, hi = kNumAlphaHi - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < kAlphaHiStart[mid]) hi = mid - 1;
    else if (cp > kAlphaHiEnd[mid]) lo = mid + 1;
    else return true;
  }
  return false;
}

bool is_pyspace(uint32_t cp) {  // no cp above the BMP is str.isspace()
  return cp < kTableSize && (kCharFlags[cp] & kPySpace);
}

// append str.lower()(cp) to out (1..2 codepoints). ASCII and uncased
// chars skip the mapping search entirely (FLAG_CASED is Python's own
// "could lower() change this?" answer, so the skip is exact).
void lower_into(uint32_t cp, std::vector<uint32_t> &out) {
  if (cp < 0x80) {
    out.push_back(cp >= 'A' && cp <= 'Z' ? cp | 0x20 : cp);
    return;
  }
  if (cp < kTableSize && !(kCharFlags[cp] & 16 /*FLAG_CASED*/)) {
    out.push_back(cp);
    return;
  }
  int lo = 0, hi = kNumLower - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < kLowerCp[mid]) hi = mid - 1;
    else if (cp > kLowerCp[mid]) lo = mid + 1;
    else {
      out.push_back(kLowerTo[mid][0]);
      if (kLowerTo[mid][1]) out.push_back(kLowerTo[mid][1]);
      return;
    }
  }
  out.push_back(cp);
}

// lang.py _PUNCT — the strip() set (includes the non-ASCII quotes and
// dashes listed there).
bool is_strip_punct(uint32_t cp) {
  static const uint32_t extra[] = {0xAB, 0xBB, 0x201C, 0x201D,
                                   0x2018, 0x2019, 0x2014, 0x2013};
  if (cp < 0x80) {
    static const char ascii[] = ",.;:!?\"'()[]{}<>-_/\\|*&%$#@~`+=";
    return std::strchr(ascii, static_cast<char>(cp)) != nullptr &&
           cp != 0;  // strchr matches NUL otherwise
  }
  for (uint32_t e : extra)
    if (cp == e) return true;
  return false;
}

// lang.py _STOPWORDS — 70 ASCII words. Tokens arrive as lowered
// codepoints; only all-ASCII tokens can match.
bool is_stopword(const uint32_t *cps, size_t n) {
  // sorted(ingest/lang.py _STOPWORDS) — 63 words, max len 5; the
  // parity test cross-checks this list against the Python set.
  static const char *const words[] = {
      "a", "all", "also", "an", "and", "are", "as", "at", "be", "been",
      "but", "by", "can", "for", "from", "had", "has", "have", "he",
      "her", "his", "if", "in", "into", "is", "it", "its", "may",
      "more", "most", "new", "no", "not", "of", "on", "only", "or",
      "other", "she", "so", "some", "than", "that", "the", "their",
      "them", "there", "these", "they", "this", "time", "to", "was",
      "we", "were", "what", "when", "which", "who", "will", "with",
      "would", "you"};
  if (n == 0 || n > 5) return false;
  char buf[6];
  for (size_t i = 0; i < n; ++i) {
    if (cps[i] > 0x7F) return false;
    buf[i] = static_cast<char>(cps[i]);
  }
  buf[n] = '\0';
  int lo = 0, hi = static_cast<int>(sizeof(words) / sizeof(*words)) - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    int c = std::strcmp(buf, words[mid]);
    if (c < 0) hi = mid - 1;
    else if (c > 0) lo = mid + 1;
    else return true;
  }
  return false;
}

constexpr size_t kSample = 1024;  // lang.py _SAMPLE

// UTF-8 continuation bytes have (b & 0xC0) == 0x80; everything else
// starts a codepoint. Per 8-byte word: spread the is-continuation bit
// into bit 0 of each byte lane, popcount. Measured ~20x the naive
// byte loop — these two scans are the whole-text cost of the filter
// (everything downstream touches only the ~1 KB sample).
inline uint64_t cont_mask64(uint64_t w) {
  // bit7 set AND bit6 clear, per byte lane (lane-crossing shift bits
  // are masked off)
  return ((w >> 7) & (~w >> 6)) & 0x0101010101010101ULL;
}

size_t count_cps(const uint8_t *s, size_t len) {
  size_t c = 0, i = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t w;
    std::memcpy(&w, s + i, 8);
    c += 8 - static_cast<size_t>(__builtin_popcountll(cont_mask64(w)));
  }
  for (; i < len; ++i) c += (s[i] & 0xC0) != 0x80;
  return c;
}

// byte offset of codepoint number `n` counting from byte `from`
// (`from` must sit on a codepoint boundary). Strides 8 bytes while it
// can, fine-steps the tail.
size_t advance_cps(const uint8_t *s, size_t len, size_t from, size_t n) {
  size_t i = from;
  while (n >= 8 && i + 8 <= len) {
    uint64_t w;
    std::memcpy(&w, s + i, 8);
    size_t cps = 8 - static_cast<size_t>(
        __builtin_popcountll(cont_mask64(w)));
    if (cps > n) break;  // target boundary inside this word
    n -= cps;
    i += 8;
  }
  // may sit on a continuation byte after the stride; the loop below
  // only ever STARTS a step from a boundary, so first realign
  while (i < len && (s[i] & 0xC0) == 0x80) ++i;
  while (i < len && n) {
    ++i;
    while (i < len && (s[i] & 0xC0) == 0x80) ++i;
    --n;
  }
  return i;
}

void decode_range(const uint8_t *s, size_t end, size_t i,
                  std::vector<uint32_t> &out) {
  while (i < end) {
    if (s[i] < 0x80) { out.push_back(s[i]); ++i; continue; }
    out.push_back(decode(s, end, i));
  }
}

// lang.py _sample as BYTES: text[:341] + " " + text[mid-170 : mid+170]
// + " " + text[-341:] when len > 1024 codepoints (slice boundaries are
// codepoint counts; only the sampled slices are ever copied — the text
// can be far larger). `ascii` marks a sample with no byte >= 0x80,
// which unlocks the byte-level score path below.
struct Sample {
  std::vector<uint8_t> bytes;
  bool ascii;
};

Sample take_sample(const uint8_t *s, size_t len) {
  Sample sm;
  sm.ascii = true;
  const size_t n = count_cps(s, len);
  auto put = [&](size_t from, size_t to) {
    size_t off = sm.bytes.size();
    sm.bytes.resize(off + (to - from));
    std::memcpy(sm.bytes.data() + off, s + from, to - from);
    uint8_t acc = 0;
    for (size_t i = from; i < to; ++i) acc |= s[i];
    sm.ascii &= acc < 0x80;
  };
  if (n <= kSample) {
    sm.bytes.reserve(len);
    put(0, len);
    return sm;
  }
  const size_t third = kSample / 3;           // 341
  const size_t mid = n / 2;
  sm.bytes.reserve(4 * kSample + 2);          // worst-case 4 B/cp
  size_t b0 = advance_cps(s, len, 0, third);
  put(0, b0);
  sm.bytes.push_back(' ');
  size_t b1 = advance_cps(s, len, b0, (mid - third / 2) - third);
  size_t b2 = advance_cps(s, len, b1, third / 2 * 2);
  put(b1, b2);
  sm.bytes.push_back(' ');
  size_t b3 = advance_cps(s, len, b2, (n - third) - (mid + third / 2));
  put(b3, len);
  return sm;
}

// lang.py latin_ratio over the sample bytes: ASCII letters vs UTF-8
// lead bytes >= 0xC0 (= non-ASCII chars) — the exact byte classes the
// Python bytes.translate deletion tables count.
double latin_ratio(const Sample &sm) {
  long letters = 0, non_ascii = 0;
  for (uint8_t b : sm.bytes) {
    uint8_t lb = b | 0x20;
    if (lb >= 'a' && lb <= 'z') ++letters;
    else if (b >= 0xC0) ++non_ascii;
  }
  long total = letters + non_ascii;
  if (!total) return 0.0;
  return static_cast<double>(letters) / static_cast<double>(total);
}

// byte-level english_score for all-ASCII samples (the common case for
// the English pages this filter accepts): identical semantics, no
// codepoint vectors. ASCII str.isspace() bytes are \t-\r, \x1c-\x1f
// and space; ASCII lower() is A-Z|0x20; ASCII isalpha() is a-z.
bool ascii_space(uint8_t b) {
  return b == ' ' || (b >= 9 && b <= 13) || (b >= 28 && b <= 31);
}

double english_score_ascii(const uint8_t *s, size_t n) {
  long hits = 0, words = 0;
  uint32_t tok[8];  // lowered prefix for the stopword probe (max 5)
  size_t i = 0;
  while (i < n) {
    while (i < n && ascii_space(s[i])) ++i;
    size_t start = i;
    while (i < n && !ascii_space(s[i])) ++i;
    size_t wl = i - start;
    if (!wl) continue;
    bool all_alpha = true;
    for (size_t k = start; k < i; ++k) {
      uint8_t lb = s[k] | 0x20;
      if (lb < 'a' || lb > 'z') { all_alpha = false; break; }
      if (k - start < 8) tok[k - start] = lb;
    }
    if (all_alpha) {
      ++words;
      if (wl <= 5 && is_stopword(tok, wl)) ++hits;
      continue;
    }
    // rare path: strip the punct set, count if a letter remains.
    // (Python lowercases before stripping; ASCII _PUNCT bytes are
    // caseless and |0x20 never maps a non-letter into a-z, so
    // stripping the raw bytes is identical.)
    size_t b = start, e = i;
    while (b < e && is_strip_punct(s[b])) ++b;
    while (e > b && is_strip_punct(s[e - 1])) --e;
    if (b == e) continue;
    bool any_alpha = false;
    for (size_t k = b; k < e; ++k) {
      uint8_t lb = s[k] | 0x20;
      if (lb >= 'a' && lb <= 'z') { any_alpha = true; break; }
    }
    if (any_alpha) {
      ++words;
      size_t sl = e - b;
      if (sl <= 5) {
        uint32_t st[5];
        for (size_t k = 0; k < sl; ++k) st[k] = s[b + k] | 0x20;
        // NOTE: Python lowercases BEFORE strip; ASCII _PUNCT chars are
        // unaffected by lower() (no byte in the set is A-Z), so
        // strip-then-lower is identical here.
        if (is_stopword(st, sl)) ++hits;
      }
    }
  }
  if (!words) return 0.0;
  return static_cast<double>(hits) / static_cast<double>(words);
}

// lang.py english_score: lowercase, split on Python whitespace, count
// stopword hits over letter-bearing words.
double english_score(const std::vector<uint32_t> &cps) {
  // lower() first, exactly like sample.lower().split()
  std::vector<uint32_t> low;
  low.reserve(cps.size() + 8);
  for (uint32_t cp : cps) lower_into(cp, low);

  long hits = 0, words = 0;
  size_t i = 0, n = low.size();
  while (i < n) {
    while (i < n && is_pyspace(low[i])) ++i;
    size_t start = i;
    while (i < n && !is_pyspace(low[i])) ++i;
    if (i == start) continue;
    const uint32_t *w = low.data() + start;
    size_t wl = i - start;
    // common case: token.isalpha()
    bool all_alpha = true;
    for (size_t k = 0; k < wl; ++k)
      if (!is_alpha(w[k])) { all_alpha = false; break; }
    if (all_alpha) {
      ++words;
      if (is_stopword(w, wl)) ++hits;
      continue;
    }
    // rare path: ws = w.strip(_PUNCT); count if it bears a letter
    size_t b = 0, e = wl;
    while (b < e && is_strip_punct(w[b])) ++b;
    while (e > b && is_strip_punct(w[e - 1])) --e;
    if (b == e) continue;
    bool any_alpha = false;
    for (size_t k = b; k < e; ++k)
      if (is_alpha(w[k])) { any_alpha = true; break; }
    if (any_alpha) {
      ++words;
      if (is_stopword(w + b, e - b)) ++hits;
    }
  }
  if (!words) return 0.0;
  return static_cast<double>(hits) / static_cast<double>(words);
}

double score_sample(const Sample &sm) {
  if (sm.ascii)
    return english_score_ascii(sm.bytes.data(), sm.bytes.size());
  std::vector<uint32_t> cps;
  cps.reserve(sm.bytes.size());
  decode_range(sm.bytes.data(), sm.bytes.size(), 0, cps);
  return english_score(cps);
}

}  // namespace

extern "C" {

double dawn_latin_ratio(const char *utf8, long len) {
  return latin_ratio(take_sample(reinterpret_cast<const uint8_t *>(utf8),
                                 static_cast<size_t>(len)));
}

double dawn_english_score(const char *utf8, long len) {
  return score_sample(take_sample(reinterpret_cast<const uint8_t *>(utf8),
                                  static_cast<size_t>(len)));
}

// 1 = accept (reads like running English prose), 0 = reject.
int dawn_is_english(const char *utf8, long len, double min_stopword_ratio,
                    double min_latin) {
  Sample sm = take_sample(reinterpret_cast<const uint8_t *>(utf8),
                          static_cast<size_t>(len));
  if (latin_ratio(sm) < min_latin) return 0;
  return score_sample(sm) >= min_stopword_ratio ? 1 : 0;
}

}  // extern "C"
