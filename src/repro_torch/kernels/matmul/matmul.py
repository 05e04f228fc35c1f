"""The three matmul schedules of the paper: K1 tiled, K4 mcast, K5 unicast.

K1 ``matmul_tiled`` computes ``C = act(A @ B + bias)`` -> ``out_dtype``
with fp32 accumulation — the port of ``matmul_mcast_tiled``, the
schedule the cost model picks for almost every projection.  Two
implementations of the one function live here:

* :func:`matmul_tiled` — the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/matmul_tiled.cu`` (bias, in its own dtype,
  activation and downcast fused in the epilogue, once, on the full K
  sum); on CPU tensors it runs the plain version.  It never falls back
  from one to the other.
* :func:`matmul_tiled_plain` — the same function in plain PyTorch: the
  product summed in fp64 and rounded to fp32 (the kernel's fp32 sum,
  without its dependence on summation order), bias and activation in
  fp32, one rounding to ``out_dtype``.

K4 ``matmul_mcast`` (the flat multicast: B fetched once per cluster of
row blocks) and K5 ``matmul_unicast`` (the classic grid that re-reads B
for every row block) compute plain ``C = A @ B`` in ``a.dtype``, with no
epilogue, as their TPU kernels do; ``kernels.api`` runs bias and
activation after them.  Each has a wrapper (``csrc/matmul_mcast.cu``,
``csrc/matmul_unicast.cu``) and a plain version: the fp64 product
rounded to fp32, then to ``a.dtype``.

Each of the three runs one of four designs, by a fixed rule in its C
entry (``wrapper.design`` names the last one), on the tensor-core
kernels of ``csrc/matmul_wgmma.cuh`` wherever B is bf16 and TMA can
read it: ``wgmma`` (bf16 A, M > 64: 128 x 128 tiles; K1 numbers them in
groups of 8 row blocks so a B tile serves the group from L2, K5 row by
row; K4's ``wgmma-cluster`` runs them in thread-block clusters along M
whose B k-tiles arrive by TMA multicast, for K-major A), ``wgmma-swapab``
(bf16 A, M <= 64: Cᵀ = Bᵀ Aᵀ with K split until the grid fills the card,
the partials summed inside the launch), ``wgmma-swapab-3xbf16`` (fp32 A,
M <= 64, the tied logits: A split into three bf16 pieces) and
``cuda-core`` (everything else).

A and B may each be bf16 or fp32 and are read through their strides,
so ``B`` can be a transposed view (the tied logits read the bf16
embedding table as ``table.t()`` without copying it).

**Groups.**  Each wrapper also takes a stack of G independent products,
A (G, M, K) and B (G, K, N) -> C (G, M, N) (K1's bias (N,) for every
group or (G, N)), in one launch: the MoE expert matmuls of
``kernels.grouped_linear``, the port of JAX's ``vmap`` of the kernel over
the expert axis, which lifts that axis into the ``pallas_call``'s grid.
The group is the grid's z in every design; each group's operands sit at
their own group stride, each group's split-K partials and tile counters
are its own.  The plain versions take the same stacks, one plain product
per group in a Python loop.
"""
from __future__ import annotations

import functools

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
    one = a.ndim == b.ndim == 2 and a.shape[1] == b.shape[0]
    grouped = a.ndim == b.ndim == 3 and a.shape[0] == b.shape[0] and a.shape[2] == b.shape[1]
    if not (one or grouped):
        raise ValueError(f"{kernel}: need (M, K) @ (K, N) or (G, M, K) @ (G, K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
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
    n = b.shape[-1]
    if bias is not None and tuple(bias.shape) not in ((n,), (*b.shape[:-2], n)):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({n},)"
                         + (f" or ({b.shape[0]}, {n})" if b.ndim == 3 else ""))


def matmul_tiled_plain(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                       *, activation: str = "none",
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp64 products rounded to
    fp32, then the fp32 epilogue (no TF32 anywhere); over a stack of
    groups, one such product per group."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, bias, activation, out_dtype)
    if a.ndim == 3:
        return torch.stack([
            matmul_tiled_plain(a[g], b[g], bias if bias is None or bias.ndim == 1 else bias[g],
                               activation=activation, out_dtype=out_dtype)
            for g in range(a.shape[0])])
    y = (a.double() @ b.double()).float()
    if bias is not None:
        y = y + bias.float()
    return ACTIVATIONS[activation](y).to(out_dtype)


#: the designs by the code their C rules return (csrc/matmul_wgmma.cuh
#: ``Design``): K1 and K5; K4 runs code 1 in thread-block clusters
TILED_DESIGNS = UNICAST_DESIGNS = ("cuda-core", "wgmma", "wgmma-swapab",
                                   "wgmma-swapab-3xbf16")
MCAST_DESIGNS = ("cuda-core", "wgmma-cluster", "wgmma-swapab", "wgmma-swapab-3xbf16")
#: each kernel's split-K tile counters, per device: one per group and
#: 64-column tile of C, zero between launches (each launch's last CTA of a
#: tile resets its counter); K is split only while the tiles of all groups
#: number fewer than the card's 132 SMs
_TILED_COUNTERS: dict[torch.device, torch.Tensor] = {}
_MCAST_COUNTERS: dict[torch.device, torch.Tensor] = {}
_UNICAST_COUNTERS: dict[torch.device, torch.Tensor] = {}
_TILES_MAX = 132


@functools.lru_cache(maxsize=1024)
def _splits(kernel: str, n: int, k: int, g: int = 1) -> int:
    """The K split of ``kernel``'s swapab designs at (N, K) over ``g``
    groups, by its C rule."""
    return getattr(_build.load(kernel), f"{kernel}_splits")(n, k, g)


def _plan(kernel: str, lib, designs, counters: dict, operands: tuple, g: int, m: int, n: int,
          k: int, dev: torch.device):
    """The design ``kernel``'s C rule picks for ``operands`` and, for a
    swapab launch that splits K, its fp32 workspace and the device's tile
    counters (else None, None)."""
    design = designs[getattr(lib, f"{kernel}_design")(*operands, g, m, n, k)]
    splits = _splits(kernel, n, k, g) if design.startswith("wgmma-swapab") else 1
    if splits == 1:
        return design, None, None
    cnt = counters.get(dev)
    if cnt is None:
        cnt = counters[dev] = torch.zeros(_TILES_MAX, dtype=torch.int32, device=dev)
    return design, torch.empty(splits * g * m * n, dtype=torch.float32, device=dev), cnt


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _operands(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """A and B as the C entries take them: pointer, dtype code, the row
    and depth strides and the group stride (0 for one product)."""
    sa = a.stride() if a.ndim == 3 else (0, *a.stride())
    sb = b.stride() if b.ndim == 3 else (0, *b.stride())
    return (a.data_ptr(), _DTYPE_CODES[a.dtype], sa[1], sa[2], sa[0],
            b.data_ptr(), _DTYPE_CODES[b.dtype], sb[1], sb[2], sb[0])


def _gmkn(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int, int]:
    """(G, M, K, N) of one product (G = 1) or of a stack of them."""
    if a.ndim == 3:
        return a.shape[0], a.shape[1], a.shape[2], b.shape[2]
    return 1, a.shape[0], a.shape[1], b.shape[1]


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
                 *, activation: str = "none",
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(a @ b + bias)`` -> ``out_dtype`` (default ``a.dtype``), for
    one product or a stack of G (``a`` (G, M, K), ``b`` (G, K, N), ``bias``
    (N,) or (G, N)): the CUDA kernel for CUDA tensors, one launch either
    way, the plain version for CPU tensors."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_tiled_plain(a, b, bias, activation=activation, out_dtype=out_dtype)
    _check(a, b, bias, activation, out_dtype)
    if bias is not None and bias.dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul_tiled: bias must be bf16 or fp32, got {bias.dtype}")
    dev = _check_device("matmul_tiled", a, b, *(() if bias is None else (bias,)))
    g, m, k, n = _gmkn(a, b)
    out = torch.empty((g, m, n) if a.ndim == 3 else (m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if bias is not None and bias.stride(-1) != 1:
        bias = bias.contiguous()
    lib = _build.load("matmul_tiled")
    operands = _operands(a, b)
    design, ws, cnt = _plan("matmul_tiled", lib, TILED_DESIGNS, _TILED_COUNTERS, operands,
                            g, m, n, k, dev)
    rc = lib.matmul_tiled(
        *operands, _ptr(bias), 0 if bias is None else _DTYPE_CODES[bias.dtype],
        0 if bias is None or bias.ndim == 1 else bias.stride(0),
        out.data_ptr(), _DTYPE_CODES[out_dtype], g, m, n, k, ACT_CODES.index(activation),
        _ptr(ws), _ptr(cnt), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "matmul_tiled")
    matmul_tiled.launches += 1
    matmul_tiled.design = design
    return out


def _flat_plain(kernel: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_operands(kernel, a, b)
    if a.ndim == 3:
        return torch.stack([_flat_plain(kernel, a[g], b[g]) for g in range(a.shape[0])])
    return (a.double() @ b.double()).float().to(a.dtype)


def matmul_mcast_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: fp64 product -> fp32 -> ``a.dtype``."""
    return _flat_plain("matmul_mcast", a, b)


def matmul_unicast_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5's function in plain PyTorch: fp64 product -> fp32 -> ``a.dtype``."""
    return _flat_plain("matmul_unicast", a, b)


def _flat(kernel: str, wrapper, designs, counters: dict, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Launch K4 or K5 (``kernel``) on CUDA operands, one product or a
    stack of them: C in a's dtype."""
    _check_operands(kernel, a, b)
    dev = _check_device(kernel, a, b)
    g, m, k, n = _gmkn(a, b)
    out = torch.empty((g, m, n) if a.ndim == 3 else (m, n), dtype=a.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load(kernel)
    operands = _operands(a, b)
    design, ws, cnt = _plan(kernel, lib, designs, counters, operands, g, m, n, k, dev)
    rc = getattr(lib, kernel)(*operands, out.data_ptr(), g, m, n, k, _ptr(ws), _ptr(cnt),
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, kernel)
    wrapper.launches += 1
    wrapper.design = design
    return out


def matmul_mcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4, ``a @ b`` in ``a.dtype`` (one product, or a stack of groups
    in one launch): the CUDA kernel for CUDA tensors (B fetched once per
    cluster of row blocks: once per launch up to :func:`mcast_cluster` x
    128 rows), the plain version for CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_mcast_plain(a, b)
    return _flat("matmul_mcast", matmul_mcast, MCAST_DESIGNS, _MCAST_COUNTERS, a, b)


def matmul_unicast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5, ``a @ b`` in ``a.dtype`` (one product, or a stack of groups
    in one launch): the CUDA kernel for CUDA tensors (B re-read for every
    row block), the plain version for CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_unicast_plain(a, b)
    return _flat("matmul_unicast", matmul_unicast, UNICAST_DESIGNS, _UNICAST_COUNTERS, a, b)


for _wrapper in (matmul_tiled, matmul_mcast, matmul_unicast):
    _wrapper.launches = 0  # kernel launches since the last reset
    _wrapper.design = None  # the design of the last launch

#: K4's wgmma-cluster cluster size (csrc/matmul_mcast.cu ``CLUSTER_SMALL``,
#: ``CLUSTER_LARGE``, ``CLUSTER_SMALL_MAX_M``): CL CTAs of 128 rows share
#: each B k-tile, so B is fetched ceil(M / (128 CL)) times per launch
MCAST_CLUSTER_SMALL, MCAST_CLUSTER_LARGE, MCAST_CLUSTER_SMALL_MAX_M = 2, 4, 256


def mcast_cluster(m: int) -> int:
    """CL of K4's wgmma-cluster design at ``m`` (> 64) rows."""
    return MCAST_CLUSTER_SMALL if m <= MCAST_CLUSTER_SMALL_MAX_M else MCAST_CLUSTER_LARGE


def kernel_blocks(m: int) -> dict[str, dict[str, int]]:
    """The CUDA kernels' tile sizes at ``m`` rows, in
    :func:`hbm_traffic_model`'s terms (rows ``bm``, columns ``bn``, depth
    ``bk``, supertile ``gm``), for their tensor-core designs (bf16 B;
    ``csrc/matmul_wgmma.cuh``'s ``SMALL_M_MAX``, ``SMALL_BN``, ``LARGE_BM``,
    ``LARGE_BN``, ``BK``).  Up to 64 rows all three run one row block of
    every row (one B fetch per launch, K split across CTAs): unicast with a
    single row block is multicast.  Beyond it 128 x 128 tiles: K1 in
    groups of 8 row blocks (``GROUP_M`` of ``csrc/matmul_tiled.cu``: gm
    1024 rows share a B tile through L2), K4 in clusters of
    :func:`mcast_cluster` row blocks (bm = CL x 128 rows share each B
    fetch), K5 one row block each."""
    if m <= 64:
        small = dict(bm=64, bn=64, bk=64)
        return {"tiled": dict(small, gm=1024), "mcast": small, "unicast": small}
    large = dict(bm=128, bn=128, bk=64)
    return {"tiled": dict(large, gm=8 * 128),
            "mcast": dict(large, bm=128 * mcast_cluster(m)), "unicast": large}


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
