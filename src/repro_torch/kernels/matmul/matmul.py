"""K1: the tiled (supertile) multicast matmul with a fused epilogue.

``C = act(A @ B + bias)`` -> ``out_dtype`` with fp32 accumulation — the
port of ``matmul_mcast_tiled``, the schedule every ``kernels.linear``
projection of the serving path runs.  Two implementations of the one
function live here:

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


def _check(a, b, bias, activation, out_dtype):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_tiled: need (M, K) @ (K, N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation!r}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"matmul_tiled: {name} must be bf16 or fp32, got {t.dtype}")
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
    dev = a.device
    if dev.type != "cuda" or b.device != dev or (bias is not None and bias.device != dev):
        raise ValueError(f"matmul_tiled: operands must share one CUDA device, got "
                         f"{a.device}, {b.device}"
                         f"{'' if bias is None else ', ' + str(bias.device)}")
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
