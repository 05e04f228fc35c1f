"""DEPRECATED matmul entry points — thin shims over
``repro_torch.kernels.api``, after the JAX package's ``kernels/matmul/ops.py``.

``mcast_matmul`` / ``tiled_matmul`` / ``unicast_matmul`` predate the
KernelOp registry; they force their schedule through the same dispatch
path as ``kernels.linear`` (so results are bit-identical to it) and emit
one DeprecationWarning per name per process.  New code calls
``kernels.linear(..., policy="<schedule>")`` or ``kernels.linear(...)``.
The block sizes are accepted and pick nothing: the CUDA kernels' tiles
are compile-time constants, as a policy's ``autotune=`` field is dropped.
"""
from __future__ import annotations

from repro_torch.kernels import api


def mcast_matmul(a, b, *, bn: int | None = None, bk: int | None = None):
    """Multicast-schedule matmul (one B fetch per tile)."""
    api.warn_deprecated("mcast_matmul", 'kernels.linear(..., policy="mcast")')
    return api.linear(a, b, policy="mcast")


def tiled_matmul(a, b, bias=None, *, gm: int | None = None, bn: int | None = None,
                 bk: int | None = None, activation: str = "none", out_dtype=None):
    """Two-level (supertile) multicast-schedule matmul with the fused
    bias + activation + downcast epilogue."""
    api.warn_deprecated("tiled_matmul", 'kernels.linear(..., policy="tiled")')
    return api.linear(a, b, bias=bias, activation=activation, out_dtype=out_dtype,
                      policy="tiled")


def unicast_matmul(a, b, *, bm: int | None = None, bn: int | None = None,
                   bk: int | None = None):
    """Multiple-unicast-schedule matmul (B re-fetched per row block)."""
    api.warn_deprecated("unicast_matmul", 'kernels.linear(..., policy="unicast")')
    return api.linear(a, b, policy="unicast")
