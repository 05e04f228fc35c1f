"""DEPRECATED SSD entry point — thin shim over the KernelOp registry,
after the JAX package's ``kernels/ssd/ops.py``.  New code:
``kernels.op("ssd")(xdt, b, c, log_a)``.  ``chunk`` is accepted and picks
nothing: the CUDA kernels' chunk is a compile-time constant."""
from __future__ import annotations

from repro_torch.kernels import api


def ssd_core(xdt, b, c, log_a, *, chunk: int | None = None):
    """SSD core: per-step log decays in, the chunked scan kernel (K9) out."""
    api.warn_deprecated("ssd_core", 'kernels.op("ssd")(...)')
    with api.use_policy("pallas"):
        return api.op("ssd")(xdt, b, c, log_a)
