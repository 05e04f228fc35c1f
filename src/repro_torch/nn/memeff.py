"""Memory-efficient blockwise attention in plain PyTorch (flash semantics).

The port of the JAX package's ``nn/memeff.py`` full-attention path:
queries in chunks of ``qc``, keys/values in chunks of ``kc`` with an
online softmax, so the working set is O(qc * kc).  It keeps the
reference's numerics exactly, since greedy tokens depend on them:

* a negative key position marks an invalid slot (padding, empty cache);
* scores come out of the QK contraction in the operand dtype, are then
  widened to fp32 and scaled;
* probabilities are cast to the V dtype before the PV product, whose
  result is rounded to the V dtype too;
* the denominator ``l`` is clamped at ``1e-30``.

Local windows (the banded path) are not part of the port yet.
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


def memeff_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                     window: int | None = None, softcap: float | None = None,
                     qc: int = 512, kc: int = 1024) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, sk, kvh, d), q_pos (b, sq), k_pos (b, sk)
    (-1 = invalid slot) -> (b, sq, h, d)."""
    if window is not None:
        raise NotImplementedError("memeff_attention: local windows are not ported yet")
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

    outs = []
    for q0 in range(0, q.shape[1], qc):
        qi = q[:, q0:q0 + qc].reshape(b, qc, kvh, g, d)
        qpi = q_pos[:, q0:q0 + qc]
        m = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, qc, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, k.shape[1], kc):
            kj, vj, kpj = k[:, k0:k0 + kc], v[:, k0:k0 + kc], k_pos[:, k0:k0 + kc]
            s = _contract("bqkgd,btkd->bkgqt", qi, kj, q.dtype) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            mask = kpj[:, None, :] >= 0  # (b, qc, kc) valid slots
            if causal:
                mask = mask & (kpj[:, None, :] <= qpi[:, :, None])
            s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = _contract("bkgqt,btkd->bkgqd", p.to(vj.dtype), vj, vj.dtype)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]
