"""DEPRECATED flash-attention entry point — thin shim over the KernelOp
registry, after the JAX package's ``kernels/flash_attention/ops.py``.  New
code: ``kernels.op("flash_attention")(q, k, v, ...)``.  ``bq`` / ``bk`` are
accepted and pick nothing: the CUDA kernels' tiles are compile-time
constants."""
from __future__ import annotations

from repro_torch.kernels import api


def flash(q, k, v, *, causal=True, window=None, softcap=None,
          bq: int | None = None, bk: int | None = None):
    api.warn_deprecated("flash", 'kernels.op("flash_attention")(...)')
    with api.use_policy("pallas"):
        return api.op("flash_attention")(q, k, v, causal=causal, window=window,
                                         softcap=softcap)
