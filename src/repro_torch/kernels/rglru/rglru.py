"""K11 and K12: the RG-LRU linear recurrence and its reversed adjoint.

The ports of the JAX package's ``rglru_scan`` (``_rglru_body``) and
``rglru_scan_bwd`` (``_rglru_bwd_body``) (Griffin / recurrentgemma):

    forward   h_t = a_t h_{t-1} + b_t,                     h_{-1} = 0
    backward  g_t = dh_t + a_{t+1} g_{t+1},  da_t = g_t h_{t-1},  db_t = g_t

over (batch, seq, d) fp32 tensors, the state carried along the sequence
for every channel.  ``h_prev`` is h shifted right one step with a zero
first row, formed by the caller from the forward's output.

Each wrapper launches its CUDA kernel (``csrc/rglru_scan_fwd.cu``,
``csrc/rglru_scan_bwd.cu``) for CUDA tensors and runs its plain version
for CPU tensors; it never falls back from one to the other.  The plain
versions walk the sequence one step at a time, in the kernels' fp32 and
in their order of operations (a product, then a sum: no fused
multiply-add), so kernel and plain version agree to the bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import check_fp32_operands, on_cpu
from repro_torch.kernels.rglru.ref import rglru_scan_ref


def _check_shapes(name, *tensors):
    shape = tuple(tensors[0].shape)
    if len(shape) != 3 or any(tuple(t.shape) != shape for t in tensors):
        raise ValueError(f"{name}: need (batch, seq, d) operands of one shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")


def rglru_scan_plain(a, b):
    """K11 in plain PyTorch: h (batch, seq, d) fp32."""
    _check_shapes("rglru_scan", a, b)
    return rglru_scan_ref(a.float(), b.float())


def rglru_scan_bwd_plain(a, h_prev, dh):
    """K12 in plain PyTorch: (da, db) fp32."""
    _check_shapes("rglru_scan_bwd", a, h_prev, dh)
    a, h_prev, dh = a.float(), h_prev.float(), dh.float()
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0])  # a_{t+1} g_{t+1}
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + carry
        da[:, t] = g * h_prev[:, t]
        db[:, t] = g
        carry = a[:, t] * g
    return da, db


def _launch(wrapper, entry, outs, *ins):
    name = wrapper.__name__
    dev = check_fp32_operands(name, *ins)
    bsz, s, d = ins[0].shape
    if outs[0].numel():
        rc = getattr(_build.load(name), entry)(
            *(t.data_ptr() for t in (*ins, *outs)), bsz, s, d,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, name)
        wrapper.launches += 1


def rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over (batch, seq, d) fp32: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if on_cpu(a, b):
        return rglru_scan_plain(a, b)
    _check_shapes("rglru_scan", a, b)
    h = torch.empty_like(a)
    _launch(rglru_scan, "rglru_scan_fwd", (h,), a, b)
    return h


def rglru_scan_bwd(a, h_prev, dh):
    """Adjoint of :func:`rglru_scan`: (da, db) fp32, from the decays, the
    forward's output shifted right one step and the output cotangent.  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if on_cpu(a, h_prev, dh):
        return rglru_scan_bwd_plain(a, h_prev, dh)
    _check_shapes("rglru_scan_bwd", a, h_prev, dh)
    da, db = torch.empty_like(a), torch.empty_like(a)
    _launch(rglru_scan_bwd, "rglru_scan_bwd", (da, db), a, h_prev, dh)
    return da, db


rglru_scan.launches = 0  # kernel launches since the last reset
rglru_scan_bwd.launches = 0
