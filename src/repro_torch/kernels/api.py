"""The kernel layer's entry points: ``linear`` and ``op(name)``.

A slim counterpart of the JAX package's ``kernels/api.py``.  The port
has one implementation per kernel family, so there is no schedule
registry, autotuner or policy: block sizes are fixed constants inside
each CUDA source.

* :func:`linear` — ``act(x @ w + bias)`` for every projection of the
  model layer, always through K1 (``matmul_tiled``).
* :func:`op` — ``op("paged_attention")(q, k_pages, v_pages, table,
  start, lengths, *scales, softcap=...)`` runs K2 (decode) for a
  single-token bf16/fp32 call and K3 (chunked prefill) otherwise.
* :func:`launch_counts` / :func:`reset_launch_counts` — one launch
  counter per kernel; the plain CPU path never moves them.

Every wrapper launches its CUDA kernel for CUDA tensors and runs the
kernel's plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.matmul.matmul import ACTIVATIONS, matmul_tiled
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)

__all__ = ["ACTIVATIONS", "KERNELS", "launch_counts", "linear", "op",
           "reset_launch_counts"]

#: the port's kernel wrappers, by kernel name (each carries ``.launches``)
KERNELS = {
    "matmul_tiled": matmul_tiled,
    "paged_attention_decode": paged_attention_decode,
    "paged_attention_prefill": paged_attention_prefill,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def linear(x: torch.Tensor, w: torch.Tensor, *, bias: torch.Tensor | None = None,
           activation: str | None = None, out_dtype: torch.dtype | None = None,
           contract_dims: int = 1) -> torch.Tensor:
    """``act(x @ w + bias)``: ``x`` (..., *k_dims), ``w`` (*k_dims,
    *out_dims) with ``contract_dims`` leading axes contracted; ``bias``
    broadcasts over ``out_dims``.  Computes in fp32 whatever the storage
    dtypes (bf16 operands widen exactly); ``out_dtype`` defaults to
    ``x.dtype``."""
    k_dims, out_dims = w.shape[:contract_dims], w.shape[contract_dims:]
    if tuple(x.shape[x.ndim - contract_dims:]) != tuple(k_dims):
        raise ValueError(f"linear: x {tuple(x.shape)} does not contract with w "
                         f"{tuple(w.shape)} over {contract_dims} dims")
    lead = x.shape[: x.ndim - contract_dims]
    m, k, n = math.prod(lead), math.prod(k_dims), math.prod(out_dims)
    y = matmul_tiled(
        x.reshape(m, k), w.reshape(k, n),
        None if bias is None else bias.reshape(n),
        activation=activation or "none", out_dtype=out_dtype or x.dtype,
    )
    return y.reshape(*lead, *out_dims)


def _paged_attention(q, k_pages, v_pages, block_table, start, lengths, *scales,
                     softcap=None):
    """q (b, s, h, d) -> (b, s, h, d): K2 for single-token bf16/fp32
    calls, K3 for multi-token calls and int8 pools."""
    if q.shape[1] == 1 and not scales:
        return paged_attention_decode(q[:, 0], k_pages, v_pages, block_table, start,
                                      lengths, softcap=softcap)[:, None]
    k_scale, v_scale = scales if scales else (None, None)
    return paged_attention_prefill(q, k_pages, v_pages, block_table, start, lengths,
                                   k_scale=k_scale, v_scale=v_scale, softcap=softcap)


_OPS = {"paged_attention": _paged_attention}


def op(name: str):
    """Look up a kernel family: ``op("paged_attention")(...)``."""
    try:
        return _OPS[name]
    except KeyError:
        raise ValueError(f"unknown kernel op: {name!r} (have {sorted(_OPS)})") from None
