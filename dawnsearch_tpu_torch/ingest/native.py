"""ctypes bridge to the C++ extraction + language-filter fast paths.

Port of dawnsearch_tpu/ingest/native.py. See native/{extract,lang}.cpp
and utils/nativelib.py (loader + build at first use). Falls back to the
pure-Python implementations in ingest/{extract,lang}.py, which have
identical semantics (tests/test_torch_ingest.py,
tests/test_torch_lang_native.py). `readers()` names what a page's trip
through iter_pages takes, and why a native library is missing; the node
logs it when ingest starts.
"""

from __future__ import annotations

import ctypes

from dawnsearch_tpu_torch.ingest.extract import ExtractedDoc
from dawnsearch_tpu_torch.ingest.extract import extract as _py_extract
from dawnsearch_tpu_torch.ingest.lang import is_english as _py_is_english
from dawnsearch_tpu_torch.utils import nativelib

# kept for the Makefile docstring contract / older callers
build = nativelib.build


def available() -> bool:
    return nativelib.get() is not None


def readers() -> dict[str, str]:
    """{"warc", "extract", "lang"} -> "native" or "python", the parsers
    iter_pages takes in this process, plus "native_error" / "warc_error"
    (g++'s or the loader's message) for a library that did not build."""
    from dawnsearch_tpu_torch.ingest import warc
    host = "native" if available() else "python"
    out = {"warc": warc.reader(), "extract": host, "lang": host}
    for key, name in (("native_error", "native"), ("warc_error", "warc")):
        if nativelib.build_error(name):
            out[key] = nativelib.build_error(name)
    return out


def extract(html: str) -> ExtractedDoc:
    """HTML -> ExtractedDoc via C++ when available, Python otherwise."""
    lib = nativelib.get()
    if lib is None:
        return _py_extract(html)
    raw = html.encode("utf-8", errors="ignore")
    # length comes back explicitly: string_at(ptr) would stop at the
    # first NUL byte copied through from the input HTML
    out_len = ctypes.c_long(0)
    ptr = lib.dawn_extract(raw, len(raw), ctypes.byref(out_len))
    try:
        payload = ctypes.string_at(ptr, out_len.value).decode(
            "utf-8", errors="ignore")
    finally:
        lib.dawn_free(ptr)
    title, _, rest = payload.partition("\x1e")
    text, _, links = rest.partition("\x1e")
    return ExtractedDoc(title=title, text=text,
                        links=[l for l in links.split("\n") if l])


def extract_page(body: bytes) -> tuple[str, str, bool]:
    """A WARC record's body -> (title, text, repaired): what extract()
    gives for body.decode("utf-8", errors="ignore"), and whether the body
    held invalid UTF-8. Natively in one pass over the bytes, with no str
    made of the HTML and no links collected (native/extract.cpp's
    dawn_extract_page); in Python otherwise."""
    lib = nativelib.get()
    if lib is None:
        try:
            html, repaired = body.decode("utf-8"), False
        except UnicodeDecodeError:
            html, repaired = body.decode("utf-8", errors="ignore"), True
        doc = _py_extract(html)
        return doc.title, doc.text, repaired
    out_len, repaired = ctypes.c_long(0), ctypes.c_int(0)
    ptr = lib.dawn_extract_page(body, len(body), ctypes.byref(out_len),
                                ctypes.byref(repaired))
    try:
        # entity references can still encode surrogates: dropped here
        payload = ctypes.string_at(ptr, out_len.value).decode(
            "utf-8", errors="ignore")
    finally:
        lib.dawn_free(ptr)
    title, _, rest = payload.partition("\x1e")
    return title, rest.partition("\x1e")[0], bool(repaired.value)


def is_english(text: str, min_stopword_ratio: float = 0.12,
               min_latin: float = 0.85) -> bool:
    """English-prose gate via C++ when available, Python otherwise.

    The C++ twin (native/lang.cpp) returns exactly the Python answers
    (tests/test_torch_lang_native.py); ctypes releases the GIL for the
    call's duration so the pipeline's other stages keep running."""
    lib = nativelib.get()
    if lib is None:
        return _py_is_english(text, min_stopword_ratio, min_latin)
    raw = text.encode("utf-8", errors="ignore")
    return bool(lib.dawn_is_english(raw, len(raw),
                                    min_stopword_ratio, min_latin))
