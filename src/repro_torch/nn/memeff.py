"""Memory-efficient blockwise attention in plain PyTorch (flash semantics).

The port of the JAX package's ``nn/memeff.py``: queries in chunks of
``qc``, keys/values in chunks of ``kc`` with an online softmax, so the
working set is O(qc * kc) (``_full``).  A local window takes the banded
path where the band is narrower than the keys (``window + qc < sk``):
each query chunk attends only to the ``round_up(window + qc, 128)`` keys
ending at its last query (``_banded``, one softmax over the band), which
makes sliding-window layers sub-quadratic.  It keeps the reference's
numerics exactly, since greedy tokens depend on them:

* a negative key position marks an invalid slot (padding, empty cache);
* scores come out of the QK contraction in the operand dtype, are then
  widened to fp32 and scaled;
* probabilities are cast to the V dtype before the PV product, whose
  result is rounded to the V dtype too;
* the denominator ``l`` is clamped at ``1e-30``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -(2.0**30)


def _round_pow2(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _contract(eq: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """einsum with fp32 accumulation and the result rounded to ``dtype``
    (what the reference's einsum over ``dtype`` operands returns)."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype).float()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _scores(qi, kj, g, scale, softcap, dtype):
    """(b, qc, h, d) x (b, t, kvh, d) -> (b, kvh, g, qc, t) fp32 scores."""
    b, qcs, _, d = qi.shape
    s = _contract("bqkgd,btkd->bkgqt", qi.reshape(b, qcs, kj.shape[2], g, d), kj, dtype) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _mask(qp, kp, causal, window):
    m = kp[:, None, :] >= 0  # (b, qc, t) valid slots
    if causal:
        m = m & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        m = m & (qp[:, :, None] - kp[:, None, :] < window)
    return m[:, None, None]  # (b, 1, 1, qc, t)


def memeff_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                     window: int | None = None, softcap: float | None = None,
                     qc: int = 512, kc: int = 1024) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, sk, kvh, d), q_pos (b, sq), k_pos (b, sk)
    (-1 = invalid slot) -> (b, sq, h, d)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)

    qc = min(qc, _round_pow2(sq))
    pad_q = (-sq) % qc
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=0)
    kc = min(kc, _round_pow2(sk))
    pad_k = (-sk) % kc
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad_k), value=-1)

    kw = dict(qc=qc, window=window, causal=causal, softcap=softcap, scale=scale, g=g)
    banded = window is not None and window + qc < k.shape[1]
    if q.is_meta:
        out = _meta(q, k, v, q_pos, k_pos, kc=kc, banded=banded,
                    band=_round_up(window + qc, 128) if banded else 0, **kw)
    elif banded:
        out = _banded(q, k, v, q_pos, k_pos, band=_round_up(window + qc, 128), **kw)
    else:
        out = _full(q, k, v, q_pos, k_pos, kc=kc, **kw)
    return out[:, :sq]


def _meta(q, k, v, q_pos, k_pos, *, qc, kc, banded, band, **kw):
    """The chunk loops on ``meta`` tensors (the dry run): the first query
    chunk against the first key chunk (or its band), each loop counted as
    its trip count (``tp.repeated``); the output is that chunk's, tiled."""
    from repro_torch.dist import tp

    nq = q.shape[1] // qc
    if banded:
        def chunk(qi, k_, v_):
            return _banded(qi, k_, v_, q_pos[:, :qc], k_pos[:, :band], qc=qc, band=band, **kw)
        out = tp.repeated(nq, chunk, q[:, :qc], k[:, :band], v[:, :band])
    else:
        nk = k.shape[1] // kc

        def chunk(qi, k_, v_):
            def pair(qi_, kj, vj):
                return _full(qi_, kj, vj, q_pos[:, :qc], k_pos[:, :kc], qc=qc, kc=kc, **kw)
            return tp.repeated(nk, pair, qi, k_, v_)
        out = tp.repeated(nq, chunk, q[:, :qc], k[:, :kc], v[:, :kc])
    return out.repeat(1, nq, 1, 1)


def _full(q, k, v, q_pos, k_pos, *, qc, kc, window, causal, softcap, scale, g):
    b, _, h, d = q.shape
    kvh = k.shape[2]
    outs = []
    for q0 in range(0, q.shape[1], qc):
        qi, qpi = q[:, q0:q0 + qc], q_pos[:, q0:q0 + qc]
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, qc, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, k.shape[1], kc):
            kj, vj, kpj = k[:, k0:k0 + kc], v[:, k0:k0 + kc], k_pos[:, k0:k0 + kc]
            s = _scores(qi, kj, g, scale, softcap, q.dtype)
            s = torch.where(_mask(qpi, kpj, causal, window), s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = _contract("bkgqt,btkd->bkgqd", p.to(vj.dtype), vj, vj.dtype)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)


def _banded(q, k, v, q_pos, k_pos, *, qc, band, window, causal, softcap, scale, g):
    """Sliding-window attention: per query chunk, the ``band``-wide key
    band ending at the chunk's last query, its start clamped into the
    keys as JAX's ``dynamic_slice`` clamps it — O(s * band) in all."""
    b, _, h, d = q.shape
    sk = k.shape[1]
    outs = []
    for ci, q0 in enumerate(range(0, q.shape[1], qc)):
        qi, qpi = q[:, q0:q0 + qc], q_pos[:, q0:q0 + qc]
        start = min(max((ci + 1) * qc - band, 0), max(sk - band, 0))
        kj, vj, kpj = (t[:, start:start + band] for t in (k, v, k_pos))
        s = _scores(qi, kj, g, scale, softcap, q.dtype)
        s = torch.where(_mask(qpi, kpj, causal, window), s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = torch.clamp(p.sum(dim=-1), min=1e-30)
        pv = _contract("bkgqt,btkd->bkgqd", p.to(vj.dtype), vj, vj.dtype)
        out = pv / l[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)
