"""Build and load the port's native library (native/*.cpp).

One shared object holds the host-side C++ tier: the WordPiece tokenizer
(native/tokenizer.cpp) and the byte-level BPE tokenizer (native/bpe.cpp),
both bound with ctypes. It is compiled with g++ at first use, with the
reference Makefile's flags, into the package's git-ignored `_build/`
directory. The build is keyed on a hash of the sources, the headers they
include (native/*.h) and the flags, as ops/_cuda.py keys the CUDA kernels,
so an edited source never loads a stale library; unicode_tables.h is
checked in as generated (native/gen_unicode_tables.py), never regenerated
here.

The library is built and loaded once per process, under a lock. When it
cannot be built or loaded, get() returns None and logs why (the
compiler's own message included), and build_error() keeps that reason for
callers that must not fall back silently (models/tokenizer_bpe_native.py).
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

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None
BUILD_SECONDS: float | None = None  # wall time of this process's build, if it built


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cpp")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(SRC_DIR, "*.h"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdawn_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile native/*.cpp into the keyed library unless it exists;
    returns its path, or raises RuntimeError with the compiler's output.
    Concurrent builders (two processes on one checkout) take turns on a
    lock file; the library appears by atomic rename."""
    global BUILD_SECONDS
    path = library_path()
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
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, *_sources()]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        BUILD_SECONDS = time.perf_counter() - t0
    return path


def _bind(lib: ctypes.CDLL) -> None:
    p, c, n, i32 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
                    ctypes.c_int32)
    out = ctypes.POINTER(ctypes.c_int32)
    # WordPiece (tokenizer.cpp)
    lib.dawn_tok_new.restype = p
    lib.dawn_tok_new.argtypes = [c, n]
    lib.dawn_tok_encode.restype = n
    lib.dawn_tok_encode.argtypes = [p, c, n, n, out]
    lib.dawn_tok_free.restype = None
    lib.dawn_tok_free.argtypes = [p]
    # byte-level BPE (bpe.cpp)
    lib.dawn_bpe_new.restype = p
    lib.dawn_bpe_new.argtypes = [c, n, c, n, i32, i32, i32]
    lib.dawn_bpe_encode.restype = n
    lib.dawn_bpe_encode.argtypes = [p, c, n, n, out]
    lib.dawn_bpe_free.restype = None
    lib.dawn_bpe_free.argtypes = [p]


def get() -> ctypes.CDLL | None:
    """The loaded library with typed symbols (built on first call), or
    None when it cannot be built or loaded (build_error() says why)."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = build()
            lib = ctypes.CDLL(path)
            _bind(lib)
        except (OSError, RuntimeError, AttributeError) as e:
            _error = str(e)
            log.warning("native library unavailable, Python tokenizers in "
                        "use: %s", _error)
            return None
        _lib = lib
        log.info("native library loaded (%s)", os.path.basename(path))
        return _lib


def build_error() -> str | None:
    """Why get() returned None (None while it has not, or has not run)."""
    return _error
