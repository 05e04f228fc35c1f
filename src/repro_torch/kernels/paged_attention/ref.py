"""Plain PyTorch oracle for paged attention: gather pages, then attend.

The port of the JAX package's ``paged_attention/ref.py``, rounding where
it rounds: one softmax over the whole gathered sequence, the QK product
rounded to the operands' dtype before the fp32 scale (the einsum of bf16
operands returns bf16), probabilities cast to the value dtype before the
PV contraction, whose result rounds to that dtype too, and
dequant-on-gather for int8 pools.  It is the ``reference`` schedule of
the ``paged_attention`` op.  The kernels' own plain versions (``paged_attention.py``) follow
the page-by-page online softmax instead; this oracle is the independent
check that both compute attention.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -(2.0**30)


def gather_pages(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(kvh, P, ps, d) pages + (b, n) table -> (b, n*ps, kvh, d) — the
    dense-cache layout, key position = page order * page_size + slot."""
    kvh, _, ps, d = pages.shape
    b, n = block_table.shape
    g = pages[:, block_table.long()]  # (kvh, b, n, ps, d)
    return g.permute(1, 2, 3, 0, 4).reshape(b, n * ps, kvh, d)


def paged_attention_ref(q, k_pages, v_pages, block_table, start, lengths, *,
                        softcap=None, k_scale=None, v_scale=None):
    """q (b, s, h, d) at positions start..start+s-1 -> (b, s, h, d)."""
    b, s, h, d = q.shape
    kvh = k_pages.shape[0]
    group = h // kvh
    k = gather_pages(k_pages, block_table)
    v = gather_pages(v_pages, block_table)
    if k_scale is not None:
        k = (k.float() * gather_pages(k_scale, block_table).float()).to(torch.bfloat16)
        v = (v.float() * gather_pages(v_scale, block_table).float()).to(torch.bfloat16)
    t = k.shape[1]
    q5 = q.reshape(b, s, kvh, group, d)
    logits = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float())
    logits = logits.to(torch.result_type(q5, k)).float() / math.sqrt(d)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = start.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    kp = torch.arange(t, device=q.device)[None, None, None, None, :]
    mask = (kp <= qpos[:, None, None, :, None]) \
        & (kp < lengths.long()[:, None, None, None, None])
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs.float(), v.float())
    return out.to(v.dtype).reshape(b, s, h, d)
