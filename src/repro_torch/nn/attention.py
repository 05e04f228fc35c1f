"""Grouped-query attention with RoPE and QKV bias over dense or paged KV.

The port of the JAX package's ``nn/attention.py``: full-sequence
attention (prefill, through :func:`memeff_attention`; causal, or
bidirectional for an encoder), encoder-decoder cross attention
(:func:`cross_attention`, no RoPE), decode against a dense ring-buffer cache
(:func:`decode_attention`, the dense ``Server``) and decode / suffix
prefill against a page pool (:func:`paged_decode_attention`, through
the paged-attention kernels).  Local windows (a key is visible while
``q_pos - k_pos < window``) run on the first two; the page pools serve
global attention only (``models.lm.init_paged_cache`` refuses a windowed
arch, as in the JAX package).  Projection weights are 2-D: ``wq``
(d_model, heads*head_dim), ``wo`` (heads*head_dim, d_model).

Caches and page pools are updated **in place** (the JAX package
returns new arrays and relies on buffer donation to avoid the copy).

Inside a model axis (:mod:`repro_torch.dist.tp`) that holds this rank's
query heads, the full-sequence and cross attention compute those heads:
q / k / v column-parallel, ``wo`` row-parallel with ``bo`` added after
the all-reduce.  Where the kv heads replicate (fewer than the ranks), a
rank projects only the kv heads its query heads read.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.configs.base import AttnConfig
from repro_torch.dist import tp
from repro_torch.nn.memeff import memeff_attention
from repro_torch.nn.module import rope, softcap
from repro_torch.nn.spec import ParamSpec

NEG_INF = -(2.0**30)  # large-negative in fp32, as the reference


def attn_spec(d_model: int, cfg: AttnConfig):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d_model, h * hd), dims=(d_model, h, hd),
                        axes=("embed", "heads", None)),
        "wk": ParamSpec((d_model, kv * hd), dims=(d_model, kv, hd),
                        axes=("embed", "kv_heads", None)),
        "wv": ParamSpec((d_model, kv * hd), dims=(d_model, kv, hd),
                        axes=("embed", "kv_heads", None)),
        # the reference initialises wo (h, hd, d) with fan-in h
        "wo": ParamSpec((h * hd, d_model), init="normal", scale=1.0 / math.sqrt(h),
                        dims=(h, hd, d_model), axes=("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((h * hd,), init="zeros", dims=(h, hd), axes=("heads", None))
        spec["bk"] = ParamSpec((kv * hd,), init="zeros", dims=(kv, hd), axes=("kv_heads", None))
        spec["bv"] = ParamSpec((kv * hd,), init="zeros", dims=(kv, hd), axes=("kv_heads", None))
    if cfg.out_bias:
        spec["bo"] = ParamSpec((d_model,), init="zeros", axes=("embed",))
    return spec


class KvCache(NamedTuple):
    """Position-explicit dense KV cache (a ring buffer over ``slots``):
    what :func:`prefill` returns and the dense ``Server`` decodes against."""

    k: torch.Tensor  # (batch, slots, kv_heads, head_dim)
    v: torch.Tensor
    pos: torch.Tensor  # (batch, slots) int32, -1 = empty


def init_cache(batch: int, slots: int, cfg: AttnConfig, *, dtype=torch.bfloat16,
               device) -> KvCache:
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return KvCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    )


class PagedKvCache(NamedTuple):
    """Page-pool KV cache: position ``p`` of the sequence in batch slot
    ``b`` lives in page ``block_table[b, p // page_size]`` at row
    ``p % page_size``.  The block table and lengths are host-managed
    (``repro_torch.serve``) and shared by every layer."""

    k_pages: torch.Tensor  # (kv_heads, num_pages, page_size, head_dim)
    v_pages: torch.Tensor


def init_paged_cache(num_pages: int, page_size: int, cfg: AttnConfig, *,
                     dtype=torch.bfloat16, device) -> PagedKvCache:
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.head_dim)
    return PagedKvCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
    )


def paged_positions(x, index, lengths, page_size: int, n_entries: int):
    """Absolute positions of the ``s_new`` tokens plus their (page-table
    slot, in-page row) write coordinates.  Positions at or past
    ``lengths`` (bucket padding, inactive batch slots) are redirected to
    the **null page 0** so a padded write never lands in a page some
    sequence owns.  Returns ``(positions, page_slot, row, valid)``, each
    (b, s_new)."""
    b, s_new = x.shape[0], x.shape[1]
    index = torch.as_tensor(index, device=x.device).reshape(-1).long()
    positions = (index[:, None] + torch.arange(s_new, device=x.device)[None, :])
    positions = positions.expand(b, s_new)
    valid = (positions >= 0) & (positions < lengths.long()[:, None])
    page_slot = torch.clamp(positions // page_size, 0, n_entries - 1)
    row = torch.where(valid, positions % page_size, torch.zeros_like(positions))
    return positions, page_slot, row, valid


def paged_write(pages: torch.Tensor, values: torch.Tensor, page_ids, rows) -> None:
    """Scatter new K/V rows into their pages, in place: ``pages`` (kvh,
    P, ps, d), ``values`` (b, s, kvh, d), ``page_ids``/``rows`` (b, s)."""
    pages[:, page_ids, rows] = values.permute(2, 0, 1, 3).to(pages.dtype)


def proj_heads(x, params, name: str, heads: int, head_dim: int):
    """Headed projection ``w{name}`` (with its bias ``b{name}``, if any):
    (b, s, d) -> (b, s, heads, head_dim)."""
    b, s, _ = x.shape
    w, bias = params["w" + name], params.get("b" + name)
    return kernels.linear(x, w, bias=bias).reshape(b, s, heads, head_dim)


class _Heads(NamedTuple):
    """The heads a rank of the model axis computes: ``hl`` query heads
    from ``q0``; kv heads ``k0 .. k1``, held (``kv_cut``) or, where the
    kv heads replicate, cut from the whole weight; ``expand``: each query
    head's kv head among those, where they do not group evenly."""

    hl: int
    q0: int
    k0: int
    k1: int
    kv_cut: bool
    expand: tuple | None


def _heads(params, cfg: AttnConfig) -> _Heads | None:
    """Where the model axis holds this rank's query heads
    (:mod:`repro_torch.dist.tp`), which heads it computes; None where
    the heads replicate (every rank computes the whole attention, as
    GSPMD leaves it) or off the axis."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if not tp.split(params["wq"], 1, h * hd):
        return None
    q0, hl = tp.active().piece(h)
    g = h // kv
    k0, k1 = q0 // g, (q0 + hl - 1) // g + 1
    own = [(q0 + j) // g - k0 for j in range(hl)]
    n = k1 - k0
    even = hl % n == 0 and own == [j // (hl // n) for j in range(hl)]
    return _Heads(hl, q0, k0, k1, tp.split(params["wk"], 1, kv * hd),
                  None if even else tuple(own))


def _kv_proj(params, name: str, t: _Heads, hd: int):
    """``(w, bias, None)`` of a rank's kv heads ``t.k0 .. t.k1`` of
    projection ``w{name}``: its own piece, or those columns of the whole
    weight, whose gradient the ranks sharing it then sum (``tp.copy_in``)."""
    w, bias = params["w" + name], params.get("b" + name)
    if not t.kv_cut:
        w = tp.copy_in(w)[:, t.k0 * hd:t.k1 * hd]
        bias = None if bias is None else tp.copy_in(bias)[t.k0 * hd:t.k1 * hd]
    return w, bias, None


def _kv_heads(y, t: _Heads, hd: int):
    b, s, _ = y.shape
    y = y.reshape(b, s, t.k1 - t.k0, hd)
    return y if t.expand is None else y[:, :, list(t.expand)]


def _qkv(params, x, cfg: AttnConfig, positions, kv_input=None):
    """Queries from ``x``, keys and values from ``kv_input`` (default
    ``x``): over the model axis, the rank's heads (:func:`_heads`), the
    projections of one input column-parallel together (``tp.col_linears``)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = _heads(params, cfg)
    src = x if kv_input is None else kv_input
    if t is None:
        q = proj_heads(x, params, "q", h, hd)
        k = proj_heads(src, params, "k", kv, hd)
        v = proj_heads(src, params, "v", kv, hd)
    else:
        b, s, _ = x.shape
        q_proj = (params["wq"], params.get("bq"), None)
        kv_projs = [_kv_proj(params, "k", t, hd), _kv_proj(params, "v", t, hd)]
        if kv_input is None:
            q, k, v = tp.col_linears(x, [q_proj, *kv_projs])
        else:
            (q,), (k, v) = tp.col_linears(x, [q_proj]), tp.col_linears(src, kv_projs)
        q = q.reshape(b, s, t.hl, hd)
        k, v = _kv_heads(k, t, hd), _kv_heads(v, t, hd)
    if positions is None:
        return q, k, v
    if cfg.rope:
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k, cfg: AttnConfig):
    """(b, s, h, hd) x (b, t, kv, hd) -> (b, kv, g, s, t) fp32 logits.
    The reference's einsum of bf16 operands returns bf16, so the scores
    round to the operand dtype before the fp32 scale and softcap."""
    b, s, h, hd = q.shape
    kv = cfg.n_kv_heads
    q5 = q.reshape(b, s, kv, h // kv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", q5.float(), k.float())
    logits = logits.to(torch.result_type(q, k)).float() / math.sqrt(hd)
    return softcap(logits, cfg.logit_softcap)


def _attend(q, k, v, mask, cfg: AttnConfig):
    """Masked softmax attention; the probabilities are cast to the V
    dtype before the PV product, whose result rounds to that dtype too."""
    logits = torch.where(mask, _gqa_scores(q, k, cfg), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    b, s = q.shape[0], q.shape[1]
    out = torch.einsum("bkgst,btkh->bskgh", probs.float(), v.float())
    return out.to(torch.result_type(probs, v)).reshape(b, s, cfg.n_heads, cfg.head_dim)


def _proj_out(params, o, cfg: AttnConfig):
    """``wo`` over the heads of ``o``; row-parallel where the model axis
    holds this rank's heads (``bo`` added after the all-reduce)."""
    b, s, hl = o.shape[0], o.shape[1], o.shape[2]
    o = o.reshape(b, s, hl * cfg.head_dim)
    if hl != cfg.n_heads:
        return tp.row_linear(o, params["wo"], bias=params.get("bo"))
    return kernels.linear(o, params["wo"], bias=params.get("bo"))


def attention(params, x, cfg: AttnConfig, *, positions=None, window: int | None = None,
              causal: bool = True):
    """Self-attention over a full sequence, causal (a decoder) or not (an
    encoder); ``window``: a local window, banded where it is narrower than
    the sequence.  x (b, seq, d_model).  Returns ``(out, (k, v))`` — the
    keys and values, for the prefill cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    pos = positions.expand(b, s).to(torch.int32)
    o = memeff_attention(q, k, v, pos, pos, causal=causal, window=window,
                         softcap=cfg.logit_softcap)
    return _proj_out(params, o, cfg), (k, v)


def cross_attention(params, x, kv_input, cfg: AttnConfig):
    """Encoder-decoder cross attention (no RoPE on either side, every key
    visible): queries from ``x`` (b, s, d), keys and values from
    ``kv_input`` (b, t, d).  Returns ``(out, (k, v))`` — the keys and
    values, for the decode cache."""
    q, k, v = _qkv(params, x, cfg, None, kv_input=kv_input)
    b, s, t = x.shape[0], x.shape[1], kv_input.shape[1]
    qp = torch.arange(s, device=x.device, dtype=torch.int32).expand(b, s)
    kp = torch.arange(t, device=x.device, dtype=torch.int32).expand(b, t)
    o = memeff_attention(q, k, v, qp, kp, causal=False, softcap=cfg.logit_softcap)
    return _proj_out(params, o, cfg), (k, v)


def decode_attention(params, x, cache: KvCache, cfg: AttnConfig, *, index,
                     window: int | None = None):
    """One (or a few) decode steps against a dense ring-buffer cache,
    which is updated in place.

    ``x``: (b, s_new, d_model); ``index`` is the absolute position of the
    first new token — a scalar, or (b,) for ragged continuous batching
    (every slot at its own position).  New K/V rows land at slot
    ``position % slots``; a key is visible when its stored position is
    set, not after the query's and, with a ``window``, less than
    ``window`` before it."""
    b, s_new = x.shape[0], x.shape[1]
    slots = cache.k.shape[1]
    index = torch.as_tensor(index, device=x.device).reshape(-1).long()
    positions = (index[:, None] + torch.arange(s_new, device=x.device)[None, :])
    positions = positions.expand(b, s_new)
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    write = positions % slots
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s_new)
    cache.k[bidx, write] = k_new.to(cache.k.dtype)
    cache.v[bidx, write] = v_new.to(cache.v.dtype)
    cache.pos[bidx, write] = positions.to(torch.int32)
    qp = positions[:, None, None, :, None]  # (b, 1, 1, s_new, 1)
    kp = cache.pos[:, None, None, None, :]  # (b, 1, 1, 1, slots)
    o = _attend(q, cache.k, cache.v, visible(qp, kp, window), cfg)
    return _proj_out(params, o, cfg), cache


def visible(qp, kp, window: int | None):
    """The dense-ring mask: a set key position, not after the query's,
    within ``window`` of it."""
    mask = (kp >= 0) & (kp <= qp)
    if window is not None:
        mask = mask & (qp - kp < window)
    return mask


def paged_decode_attention(params, x, cache: PagedKvCache, cfg: AttnConfig, *,
                           index, block_table: torch.Tensor, lengths: torch.Tensor):
    """Decode (or prefix-hit suffix prefill) against the page pool.

    ``x``: (b, s_new, d_model); ``index`` is the absolute position of the
    first new token (scalar or (b,)); ``lengths`` the valid tokens after
    this call's writes.  The new K/V rows are written into their pages
    (in place), then attention runs over all valid positions through the
    ``paged_attention`` op: K2 for single-token calls, K3 for multi-token
    suffix chunks.  Calling this per chunk leaves the same page bytes as
    one call."""
    ps = cache.k_pages.shape[2]
    positions, page_slot, rows, valid = paged_positions(
        x, index, lengths, ps, block_table.shape[1])
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    page_ids = torch.where(valid, torch.gather(block_table.long(), 1, page_slot),
                           torch.zeros_like(page_slot))
    paged_write(cache.k_pages, k_new, page_ids, rows)
    paged_write(cache.v_pages, v_new, page_ids, rows)
    o = kernels.op("paged_attention")(
        q, cache.k_pages, cache.v_pages, block_table, positions[:, 0], lengths,
        softcap=cfg.logit_softcap,
    )
    return _proj_out(params, o, cfg), cache
