"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Shared libraries with a plain C interface, compiled by nvcc for sm_90a at
first use and loaded with ctypes: `lib()` holds csrc/*.cu, the kernels of
the BERT, MPNet and RoBERTa families and the index; `long_lib()` holds
csrc/long/*.cu, the long-context kernels of ModernBERT (ops/modernbert.py)
and Qwen3 (ops/qwen3.py), built only when such a model is built, so a node
of another family never compiles them. A build is keyed on a hash of its sources, the
headers they include (csrc/*.cuh, and csrc/long/*.cuh for the long set)
and the flags, so a fresh checkout builds once and every later process (a
node, a test, chip_smoke.py) loads the cached library. The libraries land
in the package's `_build/` directory, which git ignores.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have nvcc.
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

from dawnsearch_tpu_torch.utils.logging import METRICS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# N <= 16·128: the GEMM ring's LayerNorm spans a cluster of ceil(N / 128)
# CTAs, at most 16 (csrc/gemm.cuh, MAX_CLUSTER)
MAX_LN_WIDTH = 2048

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_long_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None  # wall time of this process's build, if it built
LONG = "long"  # csrc/long/: ModernBERT's kernels, a library of their own
_NAMES = {"": "libdawn_kernels", LONG: "libdawn_long"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def _sources(subdir: str = "") -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, subdir, "*.cu")))


def library_path(subdir: str = "") -> str:
    """The keyed library of csrc/<subdir>/*.cu."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the headers the sources include are part of the key
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if subdir:
        headers += sorted(glob.glob(os.path.join(CSRC, subdir, "*.cuh")))
    for src in _sources(subdir) + headers:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{_NAMES[subdir]}-{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every nvcc; raise with the output of each that failed,
    else return their joined output."""
    outs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build(subdir: str = "") -> str:
    """Compile csrc/<subdir>/*.cu into the keyed library unless it exists;
    returns its path. Each source compiles in its own nvcc, all at once, and one
    more links them; ptxas' register and shared-memory report of every
    kernel is kept beside the library (ptxas_report()). Concurrent
    builders (two processes on one checkout) take turns on a lock file;
    the library appears by atomic rename."""
    global BUILD_SECONDS
    path = library_path(subdir)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(src)}.o"
                for src in _sources(subdir)]
        t0 = time.perf_counter()
        try:
            compiles = [[_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                         obj, src] for src, obj in zip(_sources(subdir), objs)]
            report = _wait([(cmd, _run(cmd)) for cmd in compiles])
            link = [_nvcc(), "-shared", "-o", tmp, *objs]
            _wait([(link, _run(link))])
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        with open(path + ".ptxas.txt", "w") as f:
            f.write(report)
        os.replace(tmp, path)
        if not subdir:
            BUILD_SECONDS = time.perf_counter() - t0
    return path


def ptxas_report(subdir: str = "") -> str:
    """ptxas' -v output of the build of the current sources of
    csrc/<subdir> ("" if this checkout has not built them)."""
    report = library_path(subdir) + ".ptxas.txt"
    if not os.path.exists(report):
        return ""
    with open(report) as f:
        return f.read()


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
            cdll.dawn_bert_gemm.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, f, i, p]
            cdll.dawn_bert_gemm.restype = i
            cdll.dawn_bert_layer_i8.argtypes = [ctypes.POINTER(p), i, i, i, i,
                                                i, f, i, p]
            cdll.dawn_bert_layer_i8.restype = i
            cdll.dawn_i8_gemm.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p,
                                          p, i, i, i, i, i, f, p]
            cdll.dawn_i8_gemm.restype = i
            cdll.dawn_select.argtypes = [i, i, p, p, p, p, ll, p, p, i, ll,
                                         i, i, i, p]
            cdll.dawn_select.restype = i
            cdll.dawn_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, ll,
                                            ll, ll, ll, ll, ll, f, i, i, i, p]
            cdll.dawn_attention.restype = i
            cdll.dawn_ffn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i,
                                      i, f, i, p]
            cdll.dawn_ffn.restype = i
            cdll.dawn_mean_pool.argtypes = [p, p, p, i, i, i, i, i, ll, ll,
                                            i, i, i, i, i, p]
            cdll.dawn_mean_pool.restype = i
            cdll.dawn_error_string.argtypes = [i]
            cdll.dawn_error_string.restype = ctypes.c_char_p
            _lib = cdll
        return _lib


def long_lib() -> ctypes.CDLL:
    """The loaded library of the long-context kernels, csrc/long/*.cu
    (built on first call; ops/modernbert.py and ops/qwen3.py document its
    entries)."""
    global _long_lib
    with _lock:
        if _long_lib is None:
            cdll = ctypes.CDLL(build(LONG))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            cdll.dawn_long_embed_ln.argtypes = [p, p, p, p, p, i, i, i, f, p]
            cdll.dawn_long_gemm.argtypes = [p, p, i, p, p, p, p, p, p, i, i,
                                            i, i, i, f, p]
            cdll.dawn_long_attention.argtypes = [p, p, p, i, i, i, i, i, f, p]
            cdll.dawn_qwen3_gemm.argtypes = [p, p, i, p, p, p, p, p, p, p,
                                             p, p, p, i, i, i, i, i, i, i,
                                             f, p]
            cdll.dawn_qwen3_attention.argtypes = [p, p, p, i, i, i, i, f, p]
            cdll.dawn_qwen3_embed.argtypes = [p, p, p, p, p, p, i, i, i, p]
            cdll.dawn_qwen3_last_pool.argtypes = [p, p, p, p, i, i, i, f, p]
            for fn in (cdll.dawn_long_embed_ln, cdll.dawn_long_gemm,
                       cdll.dawn_long_attention, cdll.dawn_qwen3_gemm,
                       cdll.dawn_qwen3_attention, cdll.dawn_qwen3_embed,
                       cdll.dawn_qwen3_last_pool):
                fn.restype = i
            _long_lib = cdll
        return _long_lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err != 0:
        msg = lib().dawn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(t) -> int:
    """The raw cudaStream_t of the current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on
    `device`, as a kernel argument must be."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (non-contiguous)'}")


def check_matrix(what: str, name: str, w, k: int, n: int, dt, device) -> None:
    """Raise unless w is kernel `what`'s matrix `name` of the (in, out)
    shape (k, n) in the form its GEMMs read: at bf16 the (k, n) matrix; at
    f32 the (W_hi, W_lo) pair of ops/layer.py::tf32_pair, each (n, k) f32
    (3xTF32 on the TMA + wgmma ring, which reads TF32 operands K-major)."""
    import torch
    if dt != torch.float32:
        check_tensor(w, f"{what} {name}", dt, (k, n), device)
        return
    if not (isinstance(w, tuple) and len(w) == 2):
        got = (f"{w.dtype} {tuple(w.shape)}" if isinstance(w, torch.Tensor)
               else type(w).__name__)
        raise ValueError(f"{what} {name}: at f32 the kernel takes the (W_hi, "
                         f"W_lo) pair of ops.layer.tf32_pair, got {got}")
    for part, t in zip(("hi", "lo"), w):
        check_tensor(t, f"{what} {name} {part}", dt, (n, k), device)


def count(launches: dict, name: str) -> None:
    """Count one launch of kernel `name`: in its module's `launches`
    (keyed by METRICS name; tests and chip_smoke.py read and reset it)
    and in METRICS."""
    launches[name] += 1
    METRICS.inc(name)
