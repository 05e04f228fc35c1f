"""K9 and K10: the Mamba-2 SSD chunked scan and its reverse-chunk adjoint.

The ports of the JAX package's ``ssd_scan`` (``_ssd_body``) and
``ssd_scan_bwd`` (``_ssd_bwd_body``).  Given dt-scaled inputs and
log-decays they compute

    H_t = exp(l_t) H_{t-1} + xdt_t (x) B_t,    y_t = C_t . H_t

chunk by chunk: inside a chunk of Q steps the masked (Q, Q) matrix
``M_ij = exp(lcum_i - lcum_j) (C_i . B_j)`` (j <= i) times xdt, across
chunks the carried (P, N) state.  Layouts are the JAX package's:

* ``xdt``, ``dy``  (b, h, s, P),
* ``b``, ``c``     (b, s, N), shared by every head,
* ``lcum``         (b, h, s, 1): the inclusive cumsum of the per-step
  log-decays inside each chunk (:func:`ssd_lcum`),
* ``states``       (b, h, nc, P, N): the state at the *start* of each chunk.

Unlike the JAX kernel, whose chunk must divide the sequence, the last
chunk may be short: its missing steps are identity decay with zero input
(``lcum`` repeats its last value, xdt, B and C are 0), which changes no
output.  The CUDA kernels (``csrc/ssd_scan_fwd.cu``, ``ssd_scan_bwd.cu``)
run the chunk ``SSD_CHUNK`` = 64; the plain versions take any chunk.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version (``*_plain``) for CPU tensors; it never falls back from one to the
other.  The plain versions do the kernels' chunked arithmetic in fp32 for
all chunks at once, with one sequential loop over chunks for the carried
state (the JAX bodies written over a chunk axis).  The kernels split the
same way, in three CUDA launches a call (design ``chunk-parallel``): every
chunk's own contribution and the head-shared scores C B^T, one pass over
the chunks for the carried (adjoint) state, every chunk's outputs; their
products run on the tensor cores in 3xTF32.  Each C entry returns its
design's code, which the wrapper keeps as ``wrapper.design``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import check_fp32_operands, on_cpu

SSD_CHUNK = 64  # the CUDA kernels' chunk Q: a (Q, Q) fp32 tile is 16 KB
#: the design by the code the C entries return
SSD_DESIGNS = {1: "chunk-parallel"}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ssd_lcum(log_a: torch.Tensor, chunk: int) -> torch.Tensor:
    """(b, h, s) per-step log-decays -> (b, h, s, 1) fp32 inclusive cumsum
    inside each chunk of ``chunk`` steps (the last one may be short)."""
    bsz, h, s = log_a.shape
    pad = _cdiv(s, chunk) * chunk - s
    lc = torch.nn.functional.pad(log_a.float(), (0, pad)).reshape(bsz, h, -1, chunk)
    return lc.cumsum(dim=-1).reshape(bsz, h, -1)[..., :s, None].contiguous()


def _check_shapes(name, xdt, b, c, lcum, chunk, states=None, dy=None):
    """The layout rules, for the plain versions and the kernels alike."""
    if xdt.ndim != 4 or b.ndim != 3:
        raise ValueError(f"{name}: need xdt (b, h, s, P) and b/c (b, s, N), got "
                         f"{tuple(xdt.shape)}, {tuple(b.shape)}")
    bsz, h, s, p = xdt.shape
    n = b.shape[-1]
    want = {"b": (b, (bsz, s, n)), "c": (c, (bsz, s, n)), "lcum": (lcum, (bsz, h, s, 1))}
    if states is not None:
        want["states"] = (states, (bsz, h, _cdiv(s, chunk), p, n))
    if dy is not None:
        want["dy"] = (dy, (bsz, h, s, p))
    for what, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} should be {shape}, got {tuple(t.shape)}")
    if chunk < 1:
        raise ValueError(f"{name}: chunk must be positive, got {chunk}")


def _check_kernel(name, chunk, *tensors) -> torch.device:
    """The CUDA kernels' operand rules, and their chunk; raises."""
    dev = check_fp32_operands(name, *tensors)
    if chunk != SSD_CHUNK:
        raise ValueError(f"{name}: the CUDA kernel's chunk is {SSD_CHUNK}, got {chunk}")
    return dev


def _design(rc: int, name: str) -> str:
    """The design a C entry ran; raises on minus a cudaError."""
    if rc < 0:
        _build.check(-rc, name)
    return SSD_DESIGNS[rc]


def _chunked(xdt, b, c, lcum, chunk):
    """fp32 views over (nc, Q) chunks, the short last chunk padded:
    xdt (b, h, nc, Q, P), B and C (b, 1, nc, Q, N), l (b, h, nc, Q), and
    the masked decay matrix exp(l_i - l_j) (j <= i) with the scores C B^T."""
    bsz, h, s, p = xdt.shape
    n, pad = b.shape[-1], _cdiv(s, chunk) * chunk - s
    x = torch.nn.functional.pad(xdt.float(), (0, 0, 0, pad)).reshape(bsz, h, -1, chunk, p)
    bm = torch.nn.functional.pad(b.float(), (0, 0, 0, pad)).reshape(bsz, 1, -1, chunk, n)
    cm = torch.nn.functional.pad(c.float(), (0, 0, 0, pad)).reshape(bsz, 1, -1, chunk, n)
    l = lcum.float()[..., 0]
    l = torch.cat([l, l[..., -1:].expand(bsz, h, pad)], dim=-1).reshape(bsz, h, -1, chunk)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=xdt.device).tril()
    # mask inside the exp: exp(l_i - l_j) above the diagonal would overflow
    decay = torch.exp(torch.where(causal, l[..., :, None] - l[..., None, :], -1e30))
    return x, bm, cm, l, decay, cm @ bm.transpose(-1, -2)


def _unchunk(t, s):
    """(b, h, nc, Q, k) -> (b, h, s, k), dropping the padding."""
    return t.reshape(*t.shape[:2], -1, t.shape[-1])[:, :, :s]


def ssd_scan_plain(xdt, b, c, lcum, *, chunk=SSD_CHUNK, return_states=False):
    """K9 in plain PyTorch: y (b, h, s, P) fp32, and with
    ``return_states`` the chunk-initial states (b, h, nc, P, N) fp32."""
    _check_shapes("ssd_scan", xdt, b, c, lcum, chunk)
    x, bm, cm, l, decay, scores = _chunked(xdt, b, c, lcum, chunk)
    y = (decay * scores) @ x  # intra-chunk
    ltot = l[..., -1]  # (b, h, nc): the chunk's whole log-decay
    # each chunk's own input, decayed to its end: sum_j e^{ltot - l_j} xdt_j (x) B_j
    fresh = (x * torch.exp(ltot[..., None] - l)[..., None]).transpose(-1, -2) @ bm
    states = torch.empty_like(fresh)
    state = torch.zeros_like(fresh[:, :, 0])
    for ci in range(fresh.shape[2]):
        states[:, :, ci] = state
        state = torch.exp(ltot[:, :, ci])[..., None, None] * state + fresh[:, :, ci]
    y = y + torch.exp(l)[..., None] * (cm @ states.transpose(-1, -2))  # inter-chunk
    y = _unchunk(y, xdt.shape[2])
    return (y, states) if return_states else y


def _suffix_sum(x, dim):
    """Inclusive suffix cumsum, as the JAX kernel writes it:
    suffix[i] = total - (prefix[i] - x[i])."""
    return x.sum(dim=dim, keepdim=True) - (x.cumsum(dim=dim) - x)


def ssd_scan_bwd_plain(xdt, b, c, lcum, states, dy, *, chunk=SSD_CHUNK):
    """K10 in plain PyTorch: (dxdt (b, h, s, P), dB and dC per head
    (b, h, s, N), d log_a (b, h, s, 1)), all fp32.  ``states`` are the
    forward's chunk-initial states on the same chunk grid."""
    _check_shapes("ssd_scan_bwd", xdt, b, c, lcum, chunk, states, dy)
    s = xdt.shape[2]
    x, bm, cm, l, decay, scores = _chunked(xdt, b, c, lcum, chunk)
    dyc = torch.nn.functional.pad(dy.float(), (0, 0, 0, x.shape[2] * chunk - s))
    dyc = dyc.reshape(x.shape)
    h_in = states.float()
    ltot = l[..., -1]
    w, v = torch.exp(l), torch.exp(ltot[..., None] - l)  # e^{l_i}, e^{ltot - l_j}
    # G: the adjoint of each chunk's final state, carried in reverse
    fresh = (dyc * w[..., None]).transpose(-1, -2) @ cm
    gs = torch.empty_like(fresh)
    g = torch.zeros_like(fresh[:, :, 0])
    for ci in reversed(range(fresh.shape[2])):
        gs[:, :, ci] = g
        g = torch.exp(ltot[:, :, ci])[..., None, None] * g + fresh[:, :, ci]
    m = decay * scores
    t_mat = dyc @ x.transpose(-1, -2)  # T_ij = dy_i . xdt_j
    dt_mat = decay * t_mat
    dyh = dyc @ h_in  # (Q, N): dy_i H_in
    xg = x @ gs  # (Q, N): xdt_j G
    dx = m.transpose(-1, -2) @ dyc + v[..., None] * (bm @ gs.transpose(-1, -2))
    dc = dt_mat @ bm + w[..., None] * dyh
    db = dt_mat.transpose(-1, -2) @ cm + v[..., None] * xg
    # d log a_t: (a) pairs j < t <= i of Z = M * T, (b) H_in reaching y_i
    # (i >= t), (c) xdt_j (j < t) reaching the chunk's final state, (d)
    # H_in reaching the chunk's final state
    excl = _suffix_sum(m * t_mat, dim=-2)
    excl = excl.cumsum(dim=-1) - excl
    dl = torch.diagonal(excl, dim1=-2, dim2=-1)
    dl = dl + _suffix_sum(w * (dyh * cm).sum(-1), dim=-1)
    r = v * (xg * bm).sum(-1)
    dl = dl + (r.cumsum(dim=-1) - r)
    dl = dl + torch.exp(ltot)[..., None] * (h_in * gs).sum(dim=(-1, -2))[..., None]
    return (_unchunk(dx, s), _unchunk(db, s), _unchunk(dc, s), _unchunk(dl[..., None], s))


def ssd_scan(xdt, b, c, lcum, *, chunk=SSD_CHUNK, return_states=False):
    """y (b, h, s, P) fp32 — or ``(y, states)`` with ``return_states``,
    ``states[b, h, ci]`` the (P, N) state at the start of chunk ci.  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if on_cpu(xdt, b, c, lcum):
        return ssd_scan_plain(xdt, b, c, lcum, chunk=chunk, return_states=return_states)
    _check_shapes("ssd_scan", xdt, b, c, lcum, chunk)
    dev = _check_kernel("ssd_scan", chunk, xdt, b, c, lcum)
    bsz, h, s, p = xdt.shape
    n, nc = b.shape[-1], _cdiv(s, chunk)
    y = torch.empty_like(xdt)
    # the chunk-initial states are written with or without return_states,
    # and the head-shared scores C B^T once per (batch, chunk)
    states = torch.empty((bsz, h, nc, p, n), dtype=torch.float32, device=dev)
    scores = torch.empty((bsz, nc, chunk, chunk), dtype=torch.float32, device=dev)
    if y.numel():
        rc = _build.load("ssd_scan").ssd_scan_fwd(
            xdt.data_ptr(), b.data_ptr(), c.data_ptr(), lcum.data_ptr(), y.data_ptr(),
            states.data_ptr(), scores.data_ptr(), bsz, h, s, p, n,
            torch.cuda.current_stream(dev).cuda_stream)
        ssd_scan.design = _design(rc, "ssd_scan")
        ssd_scan.launches += 1
    return (y, states) if return_states else y


def ssd_scan_bwd(xdt, b, c, lcum, states, dy, *, chunk=SSD_CHUNK):
    """Adjoint of :func:`ssd_scan`: (dxdt, dB per head, dC per head,
    d log_a), fp32, dB and dC (b, h, s, N) for the caller to sum over heads
    and d log_a (b, h, s, 1) with respect to the *per-step* log-decays.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if on_cpu(xdt, b, c, lcum, states, dy):
        return ssd_scan_bwd_plain(xdt, b, c, lcum, states, dy, chunk=chunk)
    _check_shapes("ssd_scan_bwd", xdt, b, c, lcum, chunk, states, dy)
    dev = _check_kernel("ssd_scan_bwd", chunk, xdt, b, c, lcum, states, dy)
    bsz, h, s, p = xdt.shape
    n = b.shape[-1]
    dx = torch.empty_like(xdt)
    db = torch.empty((bsz, h, s, n), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    dl = torch.empty_like(lcum)
    gst = torch.empty_like(states)  # G, the adjoint of each chunk's final state
    scores = torch.empty((bsz, states.shape[2], chunk, chunk), dtype=torch.float32, device=dev)
    if dx.numel():
        rc = _build.load("ssd_scan_bwd").ssd_scan_bwd(
            xdt.data_ptr(), b.data_ptr(), c.data_ptr(), lcum.data_ptr(), states.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(), dl.data_ptr(),
            gst.data_ptr(), scores.data_ptr(), bsz, h, s, p, n,
            torch.cuda.current_stream(dev).cuda_stream)
        ssd_scan_bwd.design = _design(rc, "ssd_scan_bwd")
        ssd_scan_bwd.launches += 1
    return dx, db, dc, dl


ssd_scan.launches = 0  # wrapper calls that launched the kernel, since the last reset
ssd_scan_bwd.launches = 0
ssd_scan.design = None  # the design of the last launch
ssd_scan_bwd.design = None
