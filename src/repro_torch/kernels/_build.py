"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with :mod:`ctypes`.  The build happens at first use, from the
sources in the checkout only, into ``build/kernels/`` at the repository
root; a library's file name carries a hash of its source and flags, so a
changed source is rebuilt and never confused with a stale library.
:func:`build_all` starts one ``nvcc`` per source at once, so the whole
set builds in the time of the slowest file.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# kernel library -> (source file, C entry point, argtypes)
KERNELS = {
    "matmul_tiled": ("matmul_tiled.cu", "matmul_tiled", [
        _P, _I, _LL, _LL,          # a, a dtype, a strides (m, k)
        _P, _I, _LL, _LL,          # b, b dtype, b strides (k, n)
        _P, _P, _I,                # bias (fp32 or null), out, out dtype
        _I, _I, _I, _I,            # M, N, K, activation
        _P,                        # stream
    ]),
    "paged_attention_decode": ("paged_attention_decode.cu", "paged_attention_decode", [
        _P, _P, _P, _I,            # q, k pages, v pages, dtype
        _P, _P, _P, _P,            # block table, start, lengths, out
        _I, _I, _I, _I, _I, _I, _I,  # batch, heads, kv heads, pages, page size, head dim, width
        _F, _F,                    # scale, softcap
        _P,                        # stream
    ]),
    "paged_attention_prefill": ("paged_attention_prefill.cu", "paged_attention_prefill", [
        _P, _I, _P, _P, _I,        # q, q dtype, k pages, v pages, page dtype
        _P, _P,                    # k scale, v scale (int8 pools, else null)
        _P, _P, _P, _P,            # block table, start, lengths, out
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # batch, s, qc, heads, kv heads, pages, ps, d, width
        _F, _F,                    # scale, softcap
        _P,                        # stream
    ]),
}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the port's CUDA kernels are built from src/repro_torch/csrc at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists; returns the
    running process (or None) and the library path."""
    out = _lib_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(name: str, job, out: Path) -> None:
    if job is None:
        return
    proc, tmp = job
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {KERNELS[name][0]} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all() -> float:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together.  Returns the wall seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {name: _start(name) for name in KERNELS}
        for name, (job, out) in jobs.items():
            _finish(name, job, out)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The compiler's register / shared-memory report of the last build."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            job, out = _start(name)
            _finish(name, job, out)
            lib = ctypes.CDLL(str(out))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _LOADED[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
