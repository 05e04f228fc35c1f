"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and
loaded with :mod:`ctypes`.  The build happens at first use, from the
sources in the checkout only, into ``build/kernels/`` at the repository
root; a library's file name carries a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so a changed source is rebuilt
and never confused with a stale library.
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
        _P, _I, _LL, _LL, _LL,     # a, a dtype, a strides (m, k, group)
        _P, _I, _LL, _LL, _LL,     # b, b dtype, b strides (k, n, group)
        _P, _I, _LL,               # bias (or null), bias dtype, bias group stride
        _P, _I,                    # out, out dtype
        _I, _I, _I, _I, _I,        # G, M, N, K, activation
        _P, _P,                    # split-K workspace (fp32) and tile counters, or null
        _P,                        # stream
    ]),
    "matmul_mcast": ("matmul_mcast.cu", "matmul_mcast", [
        _P, _I, _LL, _LL, _LL,     # a, a dtype, a strides (m, k, group)
        _P, _I, _LL, _LL, _LL,     # b, b dtype, b strides (k, n, group)
        _P, _I, _I, _I, _I,        # out (a's dtype), G, M, N, K
        _P, _P,                    # split-K workspace (fp32) and tile counters, or null
        _P,                        # stream
    ]),
    "matmul_unicast": ("matmul_unicast.cu", "matmul_unicast", [
        _P, _I, _LL, _LL, _LL,     # a, a dtype, a strides (m, k, group)
        _P, _I, _LL, _LL, _LL,     # b, b dtype, b strides (k, n, group)
        _P, _I, _I, _I, _I,        # out (a's dtype), G, M, N, K
        _P, _P,                    # split-K workspace (fp32) and tile counters, or null
        _P,                        # stream
    ]),
    "paged_attention_decode": ("paged_attention_decode.cu", "paged_attention_decode", [
        _P, _P, _P, _I,            # q, k pages, v pages, dtype
        _P, _P, _P, _P,            # block table, start, lengths, out
        _P, _P,                    # split-KV workspace (fp32) and counters, or null
        _I, _I, _I, _I, _I, _I, _I,  # batch, heads, kv heads, pages, page size, head dim, width
        _F, _F,                    # scale, softcap
        _P,                        # stream
    ]),
    "paged_attention_prefill": ("paged_attention_prefill.cu", "paged_attention_prefill", [
        _P, _I, _P, _P, _I,        # q, q dtype, k pages, v pages, page dtype
        _P, _P,                    # k scale, v scale (int8 pools, else null)
        _P, _P, _P, _P,            # block table, start, lengths, out
        _P, _P,                    # split-KV workspace (fp32) and counters, or null
        _I, _I, _I, _I, _I, _I, _I, _I, _I,  # batch, s, qc, heads, kv heads, pages, ps, d, width
        _F, _F,                    # scale, softcap
        _P,                        # stream
    ]),
    "flash_attention": ("flash_attention_fwd.cu", "flash_attention_fwd", [
        _P, _P, _P, _I,            # q, k, v, dtype
        _P, _P,                    # out, lse (fp32 or null)
        _I, _I, _I, _I, _I, _I,    # batch, heads, kv heads, sq, sk, head dim
        _F, _F, _I, _I,            # scale, softcap, causal, window
        _P,                        # stream
    ]),
    "flash_attention_bwd_dq": ("flash_attention_bwd_dq.cu", "flash_attention_bwd_dq", [
        _P, _P, _P, _P, _P, _P,    # q, k, v, dO, lse, delta
        _I, _P,                    # dtype, dQ
        _I, _I, _I, _I, _I, _I,    # batch, heads, kv heads, sq, sk, head dim
        _F, _F, _I, _I,            # scale, softcap, causal, window
        _P,                        # stream
    ]),
    "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv.cu", "flash_attention_bwd_dkv", [
        _P, _P, _P, _P, _P, _P,    # q, k, v, dO, lse, delta
        _I, _P, _P,                # dtype, dK, dV (per query head)
        _I, _I, _I, _I, _I, _I,    # batch, heads, kv heads, sq, sk, head dim
        _F, _F, _I, _I,            # scale, softcap, causal, window
        _P,                        # stream
    ]),
    "ssd_scan": ("ssd_scan_fwd.cu", "ssd_scan_fwd", [
        _P, _P, _P, _P,            # xdt, b, c, lcum
        _P, _P, _P,                # y, states, scores scratch
        _I, _I, _I, _I, _I,        # batch, heads, seq, P, N
        _P,                        # stream
    ]),
    "ssd_scan_bwd": ("ssd_scan_bwd.cu", "ssd_scan_bwd", [
        _P, _P, _P, _P, _P, _P,    # xdt, b, c, lcum, states, dy
        _P, _P, _P, _P,            # dx, db, dc, dl (per head)
        _P, _P,                    # adjoint-state scratch, scores scratch
        _I, _I, _I, _I, _I,        # batch, heads, seq, P, N
        _P,                        # stream
    ]),
    "rglru_scan": ("rglru_scan_fwd.cu", "rglru_scan_fwd", [
        _P, _P, _P,                # a, b, h
        _P, _P, _P,                # look-back flags, chunk values, ticket counter
        _I, _I, _I,                # batch, seq, d
        _P,                        # stream
    ]),
    "rglru_scan_bwd": ("rglru_scan_bwd.cu", "rglru_scan_bwd", [
        _P, _P, _P, _P, _P,        # a, h_prev, dh, da, db
        _P, _P, _P,                # look-back flags, chunk values, ticket counter
        _I, _I, _I,                # batch, seq, d
        _P,                        # stream
    ]),
}

# the matmul rules' arguments: a and b as the entry takes them, G, M, N, K
_MM_OPERANDS = [_P, _I, _LL, _LL, _LL, _P, _I, _LL, _LL, _LL, _I, _I, _I, _I]
# kernel library -> its C rule (entry point, argtypes): the code of the
# design the kernel's C entry runs for those arguments, 0 the CUDA-core one
# (the flash kernels: (dtype code, head dim) -> 1 for wgmma; K1, K4, K5:
# their operands -> 1 wgmma (K4: wgmma-cluster), 2 wgmma-swapab,
# 3 wgmma-swapab-3xbf16).  K2, K3 and K9-K12 have none: their C entries
# return the code of the design they ran (K2, K3: 0 cuda-core, 1 split-kv /
# wgmma; K9, K10: 1 chunk-parallel; K11, K12: 1 chunked-lookback).
DESIGN_RULES = {
    "flash_attention": ("flash_attention_fwd_design", [_I, _I]),
    "flash_attention_bwd_dq": ("flash_attention_bwd_dq_design", [_I, _I]),
    "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv_design", [_I, _I]),
    "matmul_tiled": ("matmul_tiled_design", _MM_OPERANDS),
    "matmul_mcast": ("matmul_mcast_design", _MM_OPERANDS),
    "matmul_unicast": ("matmul_unicast_design", _MM_OPERANDS),
}
# kernel library -> further C helpers: (entry point, argtypes)
HELPERS = {
    "matmul_tiled": [("matmul_tiled_splits", [_I, _I, _I])],  # (N, K, G) -> K split
    "matmul_mcast": [("matmul_mcast_splits", [_I, _I, _I]),
                     ("matmul_mcast_cluster", [_I]),          # M -> wgmma-cluster's CL
                     ("matmul_mcast_active_clusters", [_I])],  # M -> clusters resident at once
    "matmul_unicast": [("matmul_unicast_splits", [_I, _I, _I])],
    # (dtype, batch, kv heads, page size, head dim, width) -> split-KV's split count
    "paged_attention_decode": [("paged_attention_decode_splits", [_I] * 6)],
    # (q dtype, page dtype, batch, s, qc, heads, kv heads, page size, head dim,
    # width) -> the wgmma design's split count
    "paged_attention_prefill": [("paged_attention_prefill_splits", [_I] * 10)],
}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelUnavailable(RuntimeError):
    """A kernel could not be built, loaded or launched.  The card cannot
    run that kernel at all, so a caller must not retry the step on the
    plain version: :func:`repro_torch.kernels.call_with_fallback` lets
    it propagate."""


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelUnavailable(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the port's CUDA kernels are built from src/repro_torch/csrc at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
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
        raise KernelUnavailable(f"nvcc failed for {KERNELS[name][0]} (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all(names=None) -> float:
    """Compile every kernel library (or those of ``names``) that is not
    built yet, one ``nvcc`` per source, all started together.  Returns the
    wall seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {name: _start(name) for name in (KERNELS if names is None else names)}
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
            try:
                lib = ctypes.CDLL(str(out))
                fn = getattr(lib, KERNELS[name][1])
                fn.argtypes = KERNELS[name][2]
                fn.restype = ctypes.c_int
                for entry, argtypes in ([DESIGN_RULES[name]] if name in DESIGN_RULES else []) \
                        + HELPERS.get(name, []):
                    helper = getattr(lib, entry)
                    helper.argtypes = argtypes
                    helper.restype = ctypes.c_int
            except (OSError, AttributeError) as e:
                raise KernelUnavailable(f"cannot load kernel library {out.name}: {e}") from e
            _LOADED[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise KernelUnavailable(f"CUDA kernel {name} failed to launch: cudaError {rc}")

