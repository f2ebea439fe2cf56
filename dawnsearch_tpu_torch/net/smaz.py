"""smaz short-string compression, reference-wire-compatible.

The reference smaz-compresses the url/title/text fields of Insert
packets (the reference's src/net/udp_service.rs:377-381) with the
`smaz 0.1.0` crate — a port of antirez's public-domain smaz codec.
This is the same codec from the same public 254-entry codebook (smaz.c's Smaz_rcb[254]) so a
rebuilt node can decode a reference node's Insert packets (and vice
versa).

Format: each output byte < 254 indexes CODEBOOK; 254 prefixes one
verbatim byte; 255 prefixes a run of (next byte + 1) verbatim bytes.
Compression is greedy longest-match (1..7 bytes), which reproduces the
reference implementation's output. Port of dawnsearch_tpu/net/smaz.py.
"""

from __future__ import annotations

# antirez's Smaz_rcb table, verbatim (public domain; also the table in
# the smaz 0.1.0 Rust crate the reference links).
CODEBOOK: list[bytes] = [s.encode("latin-1") for s in (
    " ", "the", "e", "t", "a", "of", "o", "and", "i", "n", "s", "e ", "r",
    " th", " t", "in", "he", "th", "h", "he ", "to", "\r\n", "l", "s ", "d",
    " a", "an", "er", "c", " o", "d ", "on", " of", "re", "of ", "t ", ", ",
    "is", "u", "at", "   ", "n ", "or", "which", "f", "m", "as", "it",
    "that", "\n", "was", "en", "  ", " w", "es", " an", " i", "\r", "f ",
    "g", "p", "nd", " s", "nd ", "ed ", "w", "ed", "http://", "for", "te",
    "ing", "y ", "The", " c", "ti", "r ", "his", "st", " in", "ar", "nt",
    ",", " to", "y", "ng", " h", "with", "le", "al", "to ", "b", "ou", "be",
    "were", " b", "se", "o ", "ent", "ha", "ng ", "their", "\"", "hi",
    "from", " f", "in ", "de", "ion", "me", "v", ".", "ve", "all", "re ",
    "ri", "ro", "is ", "co", "f t", "are", "ea", ". ", "her", " m", "er ",
    " p", "es ", "by", "they", "di", "ra", "ic", "not", "s, ", "d t", "at ",
    "ce", "la", "h ", "ne", "as ", "tio", "on ", "n t", "io", "we", " a ",
    "om", ", a", "s o", "ur", "li", "ll", "ch", "had", "this", "e t", "g ",
    "e\r\n", " wh", "ere", " co", "e o", "a ", "us", " d", "ss", "\n\r\n",
    "\r\n\r", "=\"", " be", " e", "s a", "ma", "one", "t t", "or ", "but",
    "el", "so", "l ", "e s", "s,", "no", "ter", " wa", "iv", "ho", "e a",
    " r", "hat", "s t", "ns", "ch ", "wh", "tr", "ut", "/", "have", "ly ",
    "ta", " ha", " on", "tha", "-", " l", "ati", "en ", "pe", " re",
    "there", "ass", "si", " fo", "wa", "ec", "our", "who", "its", "z", "fo",
    "rs", ">", "ot", "un", "<", "im", "th ", "nc", "ate", "><", "ver", "ad",
    " we", "ly", "ee", " n", "id", " cl", "ac", "il", "</", "rt", " wi",
    "div", "e, ", " it", "whi", " ma", "ge", "x", "e c", "men", ".com",
)]

assert len(CODEBOOK) == 254

_MAX_ENTRY = max(len(e) for e in CODEBOOK)  # 7
# longest-match lookup: prefix bytes -> code
_CODES: dict[bytes, int] = {e: i for i, e in enumerate(CODEBOOK)}


def compress(data: bytes | str) -> bytes:
    if isinstance(data, str):
        data = data.encode("utf-8")
    out = bytearray()
    verb = bytearray()

    def flush() -> None:
        while verb:
            run = verb[:256]
            del verb[:256]
            if len(run) == 1:
                out.append(254)
            else:
                out.append(255)
                out.append(len(run) - 1)
            out.extend(run)

    i, n = 0, len(data)
    while i < n:
        for j in range(min(_MAX_ENTRY, n - i), 0, -1):
            code = _CODES.get(data[i: i + j])
            if code is not None:
                flush()
                out.append(code)
                i += j
                break
        else:
            verb.append(data[i])
            i += 1
    flush()
    return bytes(out)


def decompress(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        b = data[i]
        if b == 254:
            out.append(data[i + 1])
            i += 2
        elif b == 255:
            ln = data[i + 1] + 1
            if i + 2 + ln > n:
                # a truncated verbatim run would otherwise SILENTLY
                # decode short (the 254 case above raises IndexError
                # -> ValueError in packets.decode); corrupt input must
                # not become a quietly-wrong page
                raise ValueError("smaz: truncated verbatim run")
            out.extend(data[i + 2: i + 2 + ln])
            i += 2 + ln
        else:
            out.extend(CODEBOOK[b])
            i += 1
    return bytes(out)
