"""The three matmul schedules of the paper: K1 tiled, K4 mcast, K5 unicast.

K1 ``matmul_tiled`` computes ``C = act(A @ B + bias)`` -> ``out_dtype``
with fp32 accumulation — the port of ``matmul_mcast_tiled``, the
schedule the cost model picks for almost every projection.  Two
implementations of the one function live here:

* :func:`matmul_tiled` — the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/matmul_tiled.cu`` (grouped CTA raster so a
  B tile is reused from L2 across a group of row blocks, masked ragged
  edges, bias + activation + downcast fused in the epilogue); on CPU
  tensors it runs the plain version.  It never falls back from one to
  the other.
* :func:`matmul_tiled_plain` — the same function in plain PyTorch: the
  product summed in fp64 and rounded to fp32 (the kernel's fp32 sum,
  without its dependence on summation order), bias and activation in
  fp32, one rounding to ``out_dtype``.

K4 ``matmul_mcast`` (the flat multicast: one CTA per column tile owns
every row, so each B element is read once) and K5 ``matmul_unicast``
(the classic grid that re-reads B for every row block) compute plain
``C = A @ B`` in ``a.dtype``, with no epilogue, as their TPU kernels
do; ``kernels.api`` runs bias and activation after them.  Each has a
wrapper (``csrc/matmul_mcast.cu``, ``csrc/matmul_unicast.cu``) and a
plain version: the fp64 product rounded to fp32, then to ``a.dtype``.
K5 runs one of four designs, by a fixed rule in its C entry (bf16 B
that TMA can read; ``matmul_unicast.design`` names the last one):
``wgmma`` (bf16 A, M > 64: 128 x 128 tiles on the tensor cores),
``wgmma-swapab`` (bf16 A, M <= 64: Cᵀ = Bᵀ Aᵀ with K split until the
grid fills the card, the partials summed inside the launch),
``wgmma-swapab-3xbf16`` (fp32 A, M <= 64, the tied logits: A split into
three bf16 pieces) and ``cuda-core`` (everything else).

A and B may each be bf16 or fp32 and are read through their strides,
so ``B`` can be a transposed view (the tied logits read the bf16
embedding table as ``table.t()`` without copying it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: activation names in the kernel's code order (csrc/matmul_tiled.cu)
ACT_CODES = ("none", "relu", "gelu", "gelu_tanh", "silu", "sigmoid")

ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    # the JAX reference's gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": lambda x: x * torch.sigmoid(x),
    "sigmoid": torch.sigmoid,  # RG-LRU gates fuse their sigmoid here
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(kernel: str, a, b):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{kernel}: need (M, K) @ (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{kernel}: {name} must be bf16 or fp32, got {t.dtype}")


def _check_device(kernel: str, *tensors) -> torch.device:
    """The one CUDA device all operands share; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{kernel}: operands must share one CUDA device, got "
                         f"{', '.join(str(t.device) for t in tensors)}")
    return dev


def _check(a, b, bias, activation, out_dtype):
    _check_operands("matmul_tiled", a, b)
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation!r}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul_tiled: out_dtype must be bf16 or fp32, got {out_dtype}")
    if bias is not None and tuple(bias.shape) != (b.shape[1],):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({b.shape[1]},)")


def matmul_tiled_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                       *, activation: str = "none",
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp64 products rounded to
    fp32, then the fp32 epilogue (no TF32 anywhere)."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, bias, activation, out_dtype)
    y = (a.double() @ b.double()).float()
    if bias is not None:
        y = y + bias.float()
    return ACTIVATIONS[activation](y).to(out_dtype)


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                 *, activation: str = "none",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(a @ b + bias)`` -> ``out_dtype`` (default ``a.dtype``):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_tiled_plain(a, b, bias, activation=activation, out_dtype=out_dtype)
    _check(a, b, bias, activation, out_dtype)
    dev = _check_device("matmul_tiled", a, b, *(() if bias is None else (bias,)))
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    lib = _build.load("matmul_tiled")
    rc = lib.matmul_tiled(
        a.data_ptr(), _DTYPE_CODES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPE_CODES[b.dtype], b.stride(0), b.stride(1),
        None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[out_dtype], m, n, k, ACT_CODES.index(activation),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "matmul_tiled")
    matmul_tiled.launches += 1
    return out


matmul_tiled.launches = 0  # kernel launches since the last reset


def _flat_plain(kernel: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_operands(kernel, a, b)
    return (a.double() @ b.double()).float().to(a.dtype)


def matmul_mcast_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: fp64 product -> fp32 -> ``a.dtype``."""
    return _flat_plain("matmul_mcast", a, b)


def matmul_unicast_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5's function in plain PyTorch: fp64 product -> fp32 -> ``a.dtype``."""
    return _flat_plain("matmul_unicast", a, b)


def matmul_mcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4, ``a @ b`` in ``a.dtype``: the CUDA kernel for CUDA tensors (B
    read once per launch for M <= ``MCAST_RESIDENT_ROWS``), the plain
    version for CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_mcast_plain(a, b)
    _check_operands("matmul_mcast", a, b)
    dev = _check_device("matmul_mcast", a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    rc = _build.load("matmul_mcast").matmul_mcast(
        a.data_ptr(), _DTYPE_CODES[a.dtype], a.stride(0), a.stride(1),
        b.data_ptr(), _DTYPE_CODES[b.dtype], b.stride(0), b.stride(1),
        out.data_ptr(), m, n, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "matmul_mcast")
    matmul_mcast.launches += 1
    return out


#: K5's designs by the code its C rule returns (csrc/matmul_unicast.cu ``Design``)
UNICAST_DESIGNS = ("cuda-core", "wgmma", "wgmma-swapab", "wgmma-swapab-3xbf16")
#: one split-K tile counter per 64-column tile of C, zero between launches
#: (each launch's last CTA of a tile resets its counter); K is split only
#: while the tiles number fewer than the card's 132 SMs
_UNICAST_COUNTERS: dict[torch.device, torch.Tensor] = {}
_UNICAST_TILES_MAX = 132


def matmul_unicast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5, ``a @ b`` in ``a.dtype``: the CUDA kernel for CUDA tensors (B
    re-read for every row block), the plain version for CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_unicast_plain(a, b)
    _check_operands("matmul_unicast", a, b)
    dev = _check_device("matmul_unicast", a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _build.load("matmul_unicast")
    operands = (a.data_ptr(), _DTYPE_CODES[a.dtype], a.stride(0), a.stride(1),
                b.data_ptr(), _DTYPE_CODES[b.dtype], b.stride(0), b.stride(1))
    design = UNICAST_DESIGNS[lib.matmul_unicast_design(*operands, m, n, k)]
    ws = counters = None
    splits = lib.matmul_unicast_splits(n, k) if design.startswith("wgmma-swapab") else 1
    if splits > 1:
        ws = torch.empty(splits * m * n, dtype=torch.float32, device=dev)
        counters = _UNICAST_COUNTERS.get(dev)
        if counters is None:
            counters = _UNICAST_COUNTERS[dev] = torch.zeros(_UNICAST_TILES_MAX,
                                                            dtype=torch.int32, device=dev)
    rc = lib.matmul_unicast(*operands, out.data_ptr(), m, n, k,
                            None if ws is None else ws.data_ptr(),
                            None if counters is None else counters.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "matmul_unicast")
    matmul_unicast.launches += 1
    matmul_unicast.design = design
    return out


matmul_mcast.launches = 0
matmul_unicast.launches = 0
matmul_unicast.design = None  # the design of the last launch

#: rows K4 keeps resident in one pass (csrc/matmul_mcast.cu ``RESIDENT_ROWS``):
#: up to this M every B element is read from global memory once per
#: launch; beyond it K4 walks row panels of this size, each re-reading B.
MCAST_RESIDENT_ROWS = 256


def kernel_blocks(m: int) -> dict[str, dict[str, int]]:
    """The CUDA kernels' tile sizes at ``m`` rows, in
    :func:`hbm_traffic_model`'s terms (rows ``bm``, columns ``bn``, depth
    ``bk``, supertile ``gm``): the constants of ``csrc/matmul_tiled.cu``
    (grouped raster of 8 row blocks), ``csrc/matmul_mcast.cu`` and
    ``csrc/matmul_unicast.cu``.  K5's are its tensor-core designs' (bf16
    B; ``SMALL_M_MAX``, ``SMALL_BN``, ``LARGE_BM``, ``LARGE_BN``, ``BK``):
    up to 64 rows one row block of every row (one B fetch per launch, K
    split across CTAs), beyond it 128 x 128 tiles.  Up to 64 rows K4 runs
    one row block too: unicast with a single row block is multicast."""
    tiled = dict(bm=16, bn=32, bk=128) if m <= 16 else dict(bm=64, bn=64, bk=16)
    if m <= 16:
        mcast = dict(bm=16, bn=64, bk=32)
    elif m <= 64:
        mcast = dict(bm=64, bn=64, bk=32)
    else:
        mcast = dict(bm=MCAST_RESIDENT_ROWS, bn=64, bk=16)
    unicast = dict(bm=64, bn=64, bk=64) if m <= 64 else dict(bm=128, bn=128, bk=64)
    return {"tiled": dict(tiled, gm=8 * tiled["bm"]), "mcast": mcast, "unicast": unicast}


def hbm_traffic_model(m: int, n: int, k: int, *, bm: int, bn: int, bk: int,
                      gm: int | None = None,
                      dtype_bytes: int = 4) -> dict[str, float]:
    """Analytical HBM byte counts for the schedules (the JAX package's
    model, copied).

    mcast:   B read once per (j, kk) tile; A panel re-read per j.
    tiled:   B re-read once per *supertile* (gm rows) — pass ``gm``.
    unicast: B re-read per row block i (the paper's multiple-unicast).

    Per-schedule B traffic is exposed as ``<name>_b_bytes``."""
    a_bytes, b_bytes, c_bytes = (m * k, k * n, m * n)
    j_steps, i_steps = -(-n // bn), -(-m // bm)
    schedules = {
        "mcast": {"a": a_bytes * j_steps, "b": b_bytes, "c": c_bytes},
        "unicast": {"a": a_bytes * j_steps, "b": b_bytes * i_steps, "c": c_bytes},
    }
    if gm is not None:
        schedules["tiled"] = {"a": a_bytes * j_steps, "b": b_bytes * -(-m // gm),
                              "c": c_bytes}
    flops = 2.0 * m * n * k
    out = {}
    for name, t in schedules.items():
        total = sum(t.values()) * dtype_bytes
        out[f"{name}_bytes"] = total
        out[f"{name}_b_bytes"] = t["b"] * dtype_bytes
        out[f"{name}_oi"] = flops / total
    out["oi_ratio"] = out["mcast_oi"] / out["unicast_oi"]
    return out
