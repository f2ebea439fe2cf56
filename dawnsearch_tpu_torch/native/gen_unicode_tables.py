"""Generate unicode_tables.h from Python's unicodedata + regex module.

The C++ tokenizer must tokenize EXACTLY like the Python
WordPieceTokenizer (models/tokenizer.py), whose semantics come from
unicodedata (category checks + NFD accent stripping). Rather than
approximate those tables in C++, we bake the exact answers for the BMP:
per-codepoint flags (control/space/punct/cjk) and the lower+NFD-strip
mapping used by basic_tokenize.

The byte-level BPE pre-tokenizer (native/bpe.cpp, twin of
models/tokenizer_bpe.py) additionally needs the `regex` module's
\\p{L} / \\p{N} / \\s classes — which ship their OWN Unicode tables
(measured: \\p{L} differs from str.isalpha on 9,568 codepoints), so
those ranges are generated by querying `regex` itself, full-range,
run-length encoded (~1.6k boundaries).

Run: python gen_unicode_tables.py > unicode_tables.h   (checked in;
regenerate only if tokenizer.py's / tokenizer_bpe.py's rules change)
"""

import sys
import unicodedata

FLAG_CONTROL, FLAG_SPACE, FLAG_PUNCT, FLAG_CJK, FLAG_CASED = 1, 2, 4, 8, 16
# Added for the C++ language filter (native/lang.cpp), which must match
# ingest/lang.py's str.split()/str.isalpha() semantics exactly:
FLAG_PYSPACE, FLAG_ALPHA = 32, 64  # ch.isspace() / ch.isalpha()


def is_cjk(cp: int) -> bool:  # tokenizer.py _is_cjk
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def is_punct(ch: str) -> bool:  # tokenizer.py _is_punctuation
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def is_control(ch: str) -> bool:  # tokenizer.py _is_control
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def lower_strip(ch: str) -> str:  # tokenizer.py basic_tokenize lowercase path
    out = []
    for c in ch.lower():
        for d in unicodedata.normalize("NFD", c):
            if unicodedata.category(d) != "Mn":
                out.append(d)
    return "".join(out)


def main() -> None:
    N = 0x10000
    flags = bytearray(N)
    mappings: list[tuple[int, str]] = []
    for cp in range(N):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates
            flags[cp] = FLAG_CONTROL
            continue
        ch = chr(cp)
        f = 0
        if is_control(ch):
            f |= FLAG_CONTROL
        if unicodedata.category(ch) == "Zs" or ch in " \t\n\r":
            f |= FLAG_SPACE
        if is_punct(ch):
            f |= FLAG_PUNCT
        if is_cjk(cp):
            f |= FLAG_CJK
        if ch.lower() != ch or ch.upper() != ch or \
                unicodedata.category(ch) in ("Ll", "Lu", "Lt"):
            f |= FLAG_CASED
        if ch.isspace():
            f |= FLAG_PYSPACE
        if ch.isalpha():
            f |= FLAG_ALPHA
        flags[cp] = f
        if not (f & (FLAG_CONTROL | FLAG_SPACE | FLAG_PUNCT | FLAG_CJK)):
            low = lower_strip(ch)
            if low != ch:
                mappings.append((cp, low))

    w = sys.stdout.write
    w("// generated by gen_unicode_tables.py — do not edit\n")
    w("#pragma once\n#include <cstdint>\n")
    w(f"constexpr int kTableSize = {N};\n")
    w("// 1=control 2=space 4=punct 8=cjk 16=cased\n")
    w("static const uint8_t kCharFlags[kTableSize] = {")
    w(",".join(str(b) for b in flags))
    w("};\n")
    w("// lower+NFD-strip mappings (codepoint -> utf8), sorted by cp\n")
    w(f"constexpr int kNumMappings = {len(mappings)};\n")
    w("static const uint32_t kMapCp[kNumMappings] = {")
    w(",".join(str(cp) for cp, _ in mappings))
    w("};\n")
    w("static const char* const kMapStr[kNumMappings] = {")
    w(",".join('"' + "".join(f"\\x{b:02x}" for b in s.encode("utf-8")) + '"'
               for _, s in mappings))
    w("};\n")

    # --- language-filter tables (native/lang.cpp) ---------------------
    # Pure str.lower() mappings (NO NFD strip — english_score lowercases
    # before its isalpha word check, so 'İ' -> 'i' + U+0307 matters),
    # full Unicode range, sorted by cp. Max expansion is 2 codepoints.
    lower_map: list[tuple[int, list[int]]] = []
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        lo = ch.lower()
        if lo != ch:
            lower_map.append((cp, [ord(c) for c in lo]))
    w("// pure str.lower() mappings (cp -> up to 2 cps), full range\n")
    w(f"constexpr int kNumLower = {len(lower_map)};\n")
    w("static const uint32_t kLowerCp[kNumLower] = {")
    w(",".join(str(cp) for cp, _ in lower_map))
    w("};\n")
    w("static const uint32_t kLowerTo[kNumLower][2] = {")
    w(",".join("{%d,%d}" % (tgt[0], tgt[1] if len(tgt) > 1 else 0)
               for _, tgt in lower_map))
    w("};\n")
    # str.isalpha() ranges above the BMP (the flags table covers <=BMP;
    # no cp above the BMP is str.isspace()).
    hi: list[tuple[int, int]] = []
    start = None
    for cp in range(0x10000, 0x110001):
        a = cp <= 0x10FFFF and chr(cp).isalpha()
        if a and start is None:
            start = cp
        elif not a and start is not None:
            hi.append((start, cp - 1))
            start = None
    w("// str.isalpha() ranges for cp > 0xFFFF, inclusive, sorted\n")
    w(f"constexpr int kNumAlphaHi = {len(hi)};\n")
    w("static const uint32_t kAlphaHiStart[kNumAlphaHi] = {")
    w(",".join(str(a) for a, _ in hi))
    w("};\n")
    w("static const uint32_t kAlphaHiEnd[kNumAlphaHi] = {")
    w(",".join(str(b) for _, b in hi))
    w("};\n")

    # --- byte-level BPE pre-tokenizer classes (native/bpe.cpp) --------
    # The `regex` module's \p{L}/\p{N}/\s for str patterns, full range,
    # RLE-encoded as segment boundaries. The regex module carries its
    # own Unicode tables (NOT unicodedata's), so membership is generated
    # by matching each codepoint against regex itself — the tables ARE
    # the spec, same contract as the WordPiece flags above.
    import regex
    pat_l = regex.compile(r"\p{L}")
    pat_n = regex.compile(r"\p{N}")
    pat_s = regex.compile(r"\s")
    BPE_L, BPE_N, BPE_S = 1, 2, 4
    bounds: list[int] = []
    seg_flags: list[int] = []
    prev = None
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            f = 0
        else:
            ch = chr(cp)
            f = ((BPE_L if pat_l.match(ch) else 0)
                 | (BPE_N if pat_n.match(ch) else 0)
                 | (BPE_S if pat_s.match(ch) else 0))
        if f != prev:
            bounds.append(cp)
            seg_flags.append(f)
            prev = f
    w("// regex-module \\p{L}=1 \\p{N}=2 \\s=4, RLE segment starts\n")
    w(f"constexpr int kNumBpeSeg = {len(bounds)};\n")
    w("static const uint32_t kBpeSegStart[kNumBpeSeg] = {")
    w(",".join(str(b) for b in bounds))
    w("};\n")
    w("static const uint8_t kBpeSegFlags[kNumBpeSeg] = {")
    w(",".join(str(f) for f in seg_flags))
    w("};\n")


if __name__ == "__main__":
    main()
