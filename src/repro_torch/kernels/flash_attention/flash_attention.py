"""K6, K7 and K8: blockwise (flash) attention and its two backward kernels.

The ports of the JAX package's ``flash_attention`` (forward, optional
fp32 log-sum-exp), ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` (FlashAttention-2 recompute backward).
Layouts are the JAX package's:

* ``q``, ``do``      (b, h, sq, d),
* ``k``, ``v``       (b, kvh, sk, d), ``h % kvh == 0`` (GQA: query head
  ``i`` reads kv head ``i // (h // kvh)``),
* ``lse``, ``delta`` (b, h, sq) fp32, ``delta = rowsum(do * o)``.

Masks are position-based with positions from 0 for both q and k: causal
keeps ``k_pos <= q_pos``, a window keeps ``q_pos - k_pos < window``;
masked scores are ``NEG_INF = -2**30``, so a query row that sees no key
gets ``p = 1`` for every key: the mean of V, with ``lse = NEG_INF``.

Each wrapper launches its CUDA kernel (``csrc/flash_attention_*.cu``)
for CUDA tensors and runs its plain version (``*_plain``) for CPU
tensors; it never falls back from one to the other.  Each kernel has two
designs, chosen by a fixed rule in its C entry: bf16 operands with
``d % 8 == 0`` run on the tensor cores (``wgmma`` fed by TMA, which
needs 16-byte rows and 16-byte-aligned base pointers: a misaligned one
raises), everything else on CUDA cores.  Each wrapper's ``design`` says
which ran at its last launch.

The plain versions do the kernels' arithmetic without the blocking: fp32
scores of the storage-dtype operands, the forward's probabilities
rounded to the V dtype before the PV product while ``l`` sums them
unrounded, the backward all in fp32 on upcast inputs with one rounding
of each output (the bf16 K7 also rounds dS to bf16 before dS K, and the
bf16 K8 P before Pᵀ dO).
They work a few query heads at a time, so that no (sq, sk) fp32 buffer
passes 2**28 elements.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import on_cpu

NEG_INF = -(2.0**30)
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK_ELEMS = 2**28  # the plain versions' largest (heads, sq, sk) score buffer


def _check_shapes(name, q, k, v, window, *per_query):
    """The JAX kernels' layout rules, for the plain versions and kernels alike."""
    if q.ndim != 4 or k.ndim != 4 or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: need q (b, h, sq, d) and k/v (b, kvh, sk, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, _ = q.shape
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"{name}: n_heads {h} is not a multiple of kv_heads {k.shape[1]}")
    if k.shape[2] == 0:
        raise ValueError(f"{name}: no keys (sk = 0)")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be a positive number of keys, got {window}")
    for t, shape in per_query:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _check_kernel(name, q, k, v, *, same=(), rows=()) -> torch.device:
    """Device, dtype and layout rules of the CUDA kernels; raises."""
    dev = q.device
    everything = (q, k, v, *same, *rows)
    if dev.type != "cuda" or any(t.device != dev for t in everything):
        raise ValueError(f"{name}: operands must share one CUDA device, got "
                         f"{', '.join(str(t.device) for t in everything)}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, *same)):
        raise TypeError(f"{name}: q, k, v (and do) must share one dtype, bf16 or fp32; got "
                        f"{', '.join(str(t.dtype) for t in (q, k, v, *same))}")
    if any(t.dtype != torch.float32 for t in rows):
        raise TypeError(f"{name}: lse and delta must be fp32")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if not all(t.is_contiguous() for t in everything):
        raise ValueError(f"{name}: the kernel reads contiguous tensors; got strides "
                         f"{[t.stride() for t in everything]}")
    return dev


def _mask(sq, sk, causal, window, device):
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= qp - kp < window
    return mask


def _head_chunks(b, h, sq, sk):
    step = max(1, _CHUNK_ELEMS // max(1, b * sq * sk))
    for h0 in range(0, h, step):
        yield h0, min(h, h0 + step)


def _kv_heads(t, h0, h1, group):
    """The kv heads of query heads h0..h1-1 (a gather; no copy per group)."""
    if group == 1:
        return t[:, h0:h1]
    return t[:, torch.arange(h0, h1, device=t.device) // group]


def _scores(q, k, scale, softcap):
    """fp32 scores of the operands as stored (bf16 products are exact in
    fp32), scaled, then soft-capped; returns (s, tanh or None)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if softcap is None:
        return s, None
    th = torch.tanh(s / softcap)
    return softcap * th, th


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          return_lse=False):
    """K6 in plain PyTorch: O in q's dtype, and optionally lse (b, h, sq) fp32."""
    _check_shapes("flash_attention", q, k, v, window)
    b, h, sq, d = q.shape
    sk, group = k.shape[2], h // k.shape[1]
    mask = _mask(sq, sk, causal, window, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for h0, h1 in _head_chunks(b, h, sq, sk):
        s, _ = _scores(q[:, h0:h1], _kv_heads(k, h0, h1, group), 1.0 / math.sqrt(d), softcap)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        pv = p.to(v.dtype).float() @ _kv_heads(v, h0, h1, group).float()
        o[:, h0:h1] = (pv / l).to(q.dtype)
        lse[:, h0:h1] = (m + torch.log(l))[..., 0]
    return (o, lse) if return_lse else o


def _bwd_scores(q, k, v, do, lse, delta, mask, scale, softcap):
    """The JAX kernels' shared backward-tile math on fp32 upcasts:
    ``p = exp(s - lse)`` and ``ds``, the gradient of the raw scores."""
    s, th = _scores(q, k, scale, softcap)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    return p, ds * scale


def _bwd_plain(name, q, k, v, do, lse, delta, causal, window, softcap, want_dq):
    b, h, sq, d = q.shape
    sk, group = k.shape[2], h // k.shape[1]
    _check_shapes(name, q, k, v, window, (do, tuple(q.shape)), (lse, (b, h, sq)),
                  (delta, (b, h, sq)))
    mask = _mask(sq, sk, causal, window, q.device)
    if want_dq:
        dq = torch.empty_like(q)
    else:
        dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
        dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    for h0, h1 in _head_chunks(b, h, sq, sk):
        kc, vc = _kv_heads(k, h0, h1, group), _kv_heads(v, h0, h1, group)
        qc, doc = q[:, h0:h1], do[:, h0:h1]
        p, ds = _bwd_scores(qc, kc, vc, doc, lse[:, h0:h1].float(), delta[:, h0:h1].float(),
                            mask, 1.0 / math.sqrt(d), softcap)
        if want_dq:
            dq[:, h0:h1] = (ds @ kc.float()).to(q.dtype)
        else:
            dk[:, h0:h1] = (ds.transpose(-1, -2) @ qc.float()).to(k.dtype)
            dv[:, h0:h1] = (p.transpose(-1, -2) @ doc.float()).to(v.dtype)
    return dq if want_dq else (dk, dv)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *, causal=True, window=None,
                                 softcap=None):
    """K7 in plain PyTorch: dQ in q's dtype."""
    return _bwd_plain("flash_attention_bwd_dq", q, k, v, do, lse, delta, causal, window,
                      softcap, True)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal=True, window=None,
                                  softcap=None):
    """K8 in plain PyTorch: (dK, dV) per query head, (b, h, sk, d)."""
    return _bwd_plain("flash_attention_bwd_dkv", q, k, v, do, lse, delta, causal, window,
                      softcap, False)


def _opts(d, causal, window, softcap):
    """The C entries' trailing scalars: scale, softcap (<= 0: none),
    causal, window (<= 0: none)."""
    return (1.0 / math.sqrt(d), 0.0 if softcap is None else float(softcap), int(bool(causal)),
            0 if window is None else int(window))


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, return_lse=False):
    """Blockwise attention: O (b, h, sq, d) in q's dtype, and with
    ``return_lse`` also lse (b, h, sq) fp32.  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap,
                                     return_lse=return_lse)
    _check_shapes("flash_attention", q, k, v, window)
    dev = _check_kernel("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    if o.numel():
        rc = _build.load("flash_attention").flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE_CODES[q.dtype], o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, kvh, sq, sk, d,
            *_opts(d, causal, window, softcap), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "flash_attention")
        flash_attention.launches += 1
        flash_attention.design = _design("flash_attention", q)
    return (o, lse) if return_lse else o


def _design(name, q):
    """The design kernel ``name`` runs for q's dtype and head dim, by its C
    entry's rule: "wgmma" or "cuda-core"."""
    rule = getattr(_build.load(name), _build.DESIGN_RULES[name][0])
    return "wgmma" if rule(_DTYPE_CODES[q.dtype], q.shape[3]) else "cuda-core"


def _bwd_launch(wrapper, entry, outs, q, k, v, do, lse, delta, causal, window, softcap):
    name = wrapper.__name__
    b, h, sq, d = q.shape
    _check_shapes(name, q, k, v, window, (do, tuple(q.shape)), (lse, (b, h, sq)),
                  (delta, (b, h, sq)))
    dev = _check_kernel(name, q, k, v, same=(do,), rows=(lse, delta))
    if not outs[0].numel():
        return
    rc = getattr(_build.load(name), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _DTYPE_CODES[q.dtype], *(t.data_ptr() for t in outs),
        b, h, k.shape[1], sq, k.shape[2], d, *_opts(d, causal, window, softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, name)
    wrapper.launches += 1
    wrapper.design = _design(name, q)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=True, window=None,
                           softcap=None):
    """dQ of :func:`flash_attention` from the saved ``lse`` and
    ``delta = rowsum(do * o)``, in q's dtype: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                            window=window, softcap=softcap)
    dq = torch.empty_like(q)
    _bwd_launch(flash_attention_bwd_dq, "flash_attention_bwd_dq", (dq,), q, k, v, do, lse,
                delta, causal, window, softcap)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, window=None,
                            softcap=None):
    """dK and dV of :func:`flash_attention` **per query head**, both
    (b, h, sk, d) in k's and v's dtype; under GQA the caller sums each
    group of ``h // kvh`` heads.  The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                             window=window, softcap=softcap)
    b, h = q.shape[:2]
    dk = torch.empty((b, h, *k.shape[2:]), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, *v.shape[2:]), dtype=v.dtype, device=q.device)
    _bwd_launch(flash_attention_bwd_dkv, "flash_attention_bwd_dkv", (dk, dv), q, k, v, do,
                lse, delta, causal, window, softcap)
    return dk, dv


flash_attention.launches = 0  # kernel launches since the last reset
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention.design = None  # the design of the last launch
flash_attention_bwd_dq.design = None
flash_attention_bwd_dkv.design = None
