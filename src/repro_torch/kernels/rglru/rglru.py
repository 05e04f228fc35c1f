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
versions walk the sequence one step at a time in fp32, a product then a
sum (no fused multiply-add).  The kernels (design ``chunked-lookback``,
``csrc/rglru_common.cuh``) cut the sequence into chunks of
``RGLRU_CHUNK`` steps that run in parallel: each chunk's steps are the
same walk, from a carry composed across the chunks before it (a chunk
maps its carry-in x to A x + L), so they agree with the plain versions to
fp32 rounding, not to the bit.  Each C entry returns its design's code,
which the wrapper keeps as ``wrapper.design``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import check_fp32_operands, on_cpu
from repro_torch.kernels.rglru.ref import rglru_scan_ref

RGLRU_CHUNK = 64  # the kernels' chunk T (csrc/rglru_common.cuh)
RGLRU_WIDTH = 128  # channels a kernel tile: one thread each
#: the design by the code the C entries return
RGLRU_DESIGNS = {1: "chunked-lookback"}
# (kernel, device, stream) -> (flags int32, counter int64), zeroed when
# made: the kernels tag the flags with the call's epoch and leave the
# counter ready for the next call on the same stream
_SCRATCH: dict = {}


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch(wrapper, entry, outs, *ins):
    """Launch ``entry`` on one call's scratch; keeps its design and count."""
    name = wrapper.__name__
    dev = check_fp32_operands(name, *ins)
    bsz, s, d = ins[0].shape
    if not outs[0].numel():
        return
    tiles = bsz * _cdiv(d, RGLRU_WIDTH) * _cdiv(s, RGLRU_CHUNK)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flags, counter = _SCRATCH.get((name, dev, stream), (None, None))
    if flags is None or flags.numel() < tiles:
        flags = torch.zeros(tiles, dtype=torch.int32, device=dev)
        if counter is None:
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
        _SCRATCH[(name, dev, stream)] = (flags, counter)
    # per tile and channel: the chunk's aggregate (A, L) and inclusive prefix
    vals = torch.empty(3 * tiles * RGLRU_WIDTH, dtype=torch.float32, device=dev)
    rc = getattr(_build.load(name), entry)(
        *(t.data_ptr() for t in (*ins, *outs)), flags.data_ptr(), vals.data_ptr(),
        counter.data_ptr(), bsz, s, d, stream)
    if rc < 0:
        _build.check(-rc, name)
    wrapper.design = RGLRU_DESIGNS[rc]
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
rglru_scan.design = None  # the design of the last launch
rglru_scan_bwd.design = None
