"""Build and load the port's native libraries (native/*.cpp).

Two shared objects hold the host-side C++ tier, both bound with ctypes:

- `libdawn_native`: the WordPiece tokenizer (native/tokenizer.cpp), the
  byte-level BPE tokenizer (native/bpe.cpp), the HTML extractor
  (native/extract.cpp) and the English filter (native/lang.cpp);
- `libdawn_warc`: the WARC record parser (native/warc.cpp), the one
  source that needs zlib (`-lz`).

The reference links all five into one library (its native/Makefile).
Here the WARC parser builds apart, so a host without zlib loses only the
native WARC reader (ingest/warc.py then takes the Python parser, with the
same records), never the tokenizers that serve every query.

Each library is compiled with g++ at first use, with the reference
Makefile's flags, into the package's git-ignored `_build/` directory. The
build is keyed on a hash of its sources, the headers they include
(native/*.h) and the flags, as ops/_cuda.py keys the CUDA kernels, so an
edited source never loads a stale library; unicode_tables.h is checked in
as generated (native/gen_unicode_tables.py), never regenerated here.

Each library is built and loaded once per process, under a lock. When it
cannot be built or loaded, get() (or get_warc()) returns None and logs why
(the compiler's own message included), and build_error() (or
build_error("warc")) keeps that reason for callers that must not fall
back silently (models/tokenizer_bpe_native.py) and for the node's log.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from dawnsearch_tpu_torch.utils.logging import service_logger

log = service_logger("Native")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
# library name -> (its sources in SRC_DIR, link flags)
LIBRARIES = {
    "native": (("tokenizer.cpp", "bpe.cpp", "extract.cpp", "lang.cpp"), ()),
    "warc": (("warc.cpp",), ("-lz",)),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None
_warc_lib: ctypes.CDLL | None = None
_warc_tried = False
_warc_error: str | None = None
# wall time of this process's build of each library, if it built one
BUILD_SECONDS: dict[str, float] = {}


def _sources(name: str) -> list[str]:
    return [os.path.join(SRC_DIR, f) for f in LIBRARIES[name][0]]


def library_path(name: str = "native") -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + list(LIBRARIES[name][1]))
                       .encode())
    for src in _sources(name) + sorted(glob.glob(os.path.join(SRC_DIR,
                                                              "*.h"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdawn_{name}-{h.hexdigest()[:16]}.so")


def build(name: str = "native") -> str:
    """Compile library `name` unless its keyed file exists; returns its
    path, or raises RuntimeError with the compiler's output. Concurrent
    builds (two processes on one checkout) take turns on a lock file;
    the library appears by atomic rename."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native library "
                           "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, *_sources(name),
               *LIBRARIES[name][1]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return path


def _bind(lib: ctypes.CDLL) -> None:
    p, c, n, i32, f64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
                         ctypes.c_int32, ctypes.c_double)
    out = ctypes.POINTER(ctypes.c_int32)
    # WordPiece (tokenizer.cpp)
    lib.dawn_tok_new.restype = p
    lib.dawn_tok_new.argtypes = [c, n]
    lib.dawn_tok_encode.restype = n
    lib.dawn_tok_encode.argtypes = [p, c, n, n, out, ctypes.POINTER(n)]
    lib.dawn_tok_free.restype = None
    lib.dawn_tok_free.argtypes = [p]
    # byte-level BPE (bpe.cpp)
    lib.dawn_bpe_new.restype = p
    lib.dawn_bpe_new.argtypes = [c, n, c, n, i32, i32, i32]
    lib.dawn_bpe_encode.restype = n
    lib.dawn_bpe_encode.argtypes = [p, c, n, n, out, ctypes.POINTER(n)]
    lib.dawn_bpe_free.restype = None
    lib.dawn_bpe_free.argtypes = [p]
    lib.dawn_bpe_configure.restype = None
    lib.dawn_bpe_configure.argtypes = [p, i32, i32]
    # HTML extraction (extract.cpp)
    lib.dawn_extract.restype = p
    lib.dawn_extract.argtypes = [c, n, ctypes.POINTER(n)]
    lib.dawn_extract_page.restype = p
    lib.dawn_extract_page.argtypes = [c, n, ctypes.POINTER(n),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.dawn_utf8_clean.restype = n
    lib.dawn_utf8_clean.argtypes = [c, n, p]
    lib.dawn_free.restype = None
    lib.dawn_free.argtypes = [p]
    # English filter (lang.cpp)
    lib.dawn_is_english.restype = ctypes.c_int
    lib.dawn_is_english.argtypes = [c, n, f64, f64]
    lib.dawn_english_score.restype = f64
    lib.dawn_english_score.argtypes = [c, n]
    lib.dawn_latin_ratio.restype = f64
    lib.dawn_latin_ratio.argtypes = [c, n]


def _bind_warc(lib: ctypes.CDLL) -> None:
    p, c, n = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long
    lib.dawn_warc_new.restype = p
    lib.dawn_warc_new.argtypes = []
    lib.dawn_warc_feed.restype = n
    lib.dawn_warc_feed.argtypes = [p, c, n]
    lib.dawn_warc_eof.restype = None
    lib.dawn_warc_eof.argtypes = [p]
    lib.dawn_warc_take.restype = n
    lib.dawn_warc_take.argtypes = [p, c, n, ctypes.POINTER(n), n]
    lib.dawn_warc_free.restype = None
    lib.dawn_warc_free.argtypes = [p]


def _load(name: str, bind) -> tuple[ctypes.CDLL | None, str | None]:
    try:
        path = build(name)
        lib = ctypes.CDLL(path)
        bind(lib)
    except (OSError, RuntimeError, AttributeError) as e:
        log.warning("native library %r unavailable, Python fallbacks in "
                    "use: %s", name, e)
        return None, str(e)
    log.info("native library loaded (%s)", os.path.basename(path))
    return lib, None


def get() -> ctypes.CDLL | None:
    """The tokenizer, extraction and language library with typed symbols
    (built on first call), or None when it cannot be built or loaded
    (build_error() says why)."""
    global _lib, _tried, _error
    with _lock:
        if not _tried:
            _tried = True
            _lib, _error = _load("native", _bind)
        return _lib


def get_warc() -> ctypes.CDLL | None:
    """The WARC parser library (built on first call), or None when it
    cannot be built or loaded (build_error("warc") says why)."""
    global _warc_lib, _warc_tried, _warc_error
    with _lock:
        if not _warc_tried:
            _warc_tried = True
            _warc_lib, _warc_error = _load("warc", _bind_warc)
        return _warc_lib


def build_error(name: str = "native") -> str | None:
    """Why get() (or get_warc(), for "warc") returned None; None while it
    has not, or has not run."""
    return _error if name == "native" else _warc_error
