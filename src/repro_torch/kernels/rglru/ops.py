"""DEPRECATED RG-LRU entry point — thin shim over the KernelOp registry,
after the JAX package's ``kernels/rglru/ops.py``.  New code:
``kernels.op("rglru")(a, b)``.  ``bd`` / ``bs`` are accepted and pick
nothing: the CUDA kernels' tiles are compile-time constants."""
from __future__ import annotations

from repro_torch.kernels import api


def lru_scan(a, b, *, bd: int | None = None, bs: int | None = None):
    """h_t = a_t h_{t-1} + b_t through the scan kernel (K11)."""
    api.warn_deprecated("lru_scan", 'kernels.op("rglru")(...)')
    with api.use_policy("pallas"):
        return api.op("rglru")(a, b)
