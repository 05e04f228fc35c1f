"""Grouped-query attention with RoPE and QKV bias over dense or paged KV.

The port of the JAX package's ``nn/attention.py`` for the paths the
paged serving stack runs: full-sequence attention (prefill, through
:func:`memeff_attention`) and decode / suffix prefill against a page
pool (:func:`paged_decode_attention`, through the paged-attention
kernels).  Projection weights are 2-D: ``wq`` (d_model, heads*head_dim),
``wo`` (heads*head_dim, d_model).

Page pools are updated **in place** (the JAX package returns new
arrays and relies on buffer donation to avoid the copy).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.configs.base import AttnConfig
from repro_torch.nn.memeff import memeff_attention
from repro_torch.nn.module import rope
from repro_torch.nn.spec import ParamSpec


def attn_spec(d_model: int, cfg: AttnConfig):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d_model, h * hd)),
        "wk": ParamSpec((d_model, kv * hd)),
        "wv": ParamSpec((d_model, kv * hd)),
        # the reference initialises wo (h, hd, d) with fan-in h
        "wo": ParamSpec((h * hd, d_model), init="normal", scale=1.0 / math.sqrt(h)),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((h * hd,), init="zeros")
        spec["bk"] = ParamSpec((kv * hd,), init="zeros")
        spec["bv"] = ParamSpec((kv * hd,), init="zeros")
    if cfg.out_bias:
        spec["bo"] = ParamSpec((d_model,), init="zeros")
    return spec


class KvCache(NamedTuple):
    """Dense prefill cache: what :func:`prefill` hands to the page scatter."""

    k: torch.Tensor  # (batch, slots, kv_heads, head_dim)
    v: torch.Tensor
    pos: torch.Tensor  # (batch, slots) int32, -1 = empty


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


def _qkv(params, x, cfg: AttnConfig, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = kernels.linear(x, params["wq"], bias=params.get("bq")).reshape(b, s, h, hd)
    k = kernels.linear(x, params["wk"], bias=params.get("bk")).reshape(b, s, kv, hd)
    v = kernels.linear(x, params["wv"], bias=params.get("bv")).reshape(b, s, kv, hd)
    if cfg.rope:
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _proj_out(params, o, cfg: AttnConfig):
    b, s = o.shape[0], o.shape[1]
    return kernels.linear(o.reshape(b, s, cfg.n_heads * cfg.head_dim), params["wo"],
                          bias=params.get("bo"))


def attention(params, x, cfg: AttnConfig, *, positions=None):
    """Causal self-attention over a full sequence; x (b, seq, d_model).
    Returns ``(out, (k, v))`` — the keys and values, for the prefill
    cache."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, x, cfg, positions)
    pos = positions.expand(b, s).to(torch.int32)
    o = memeff_attention(q, k, v, pos, pos, causal=True, softcap=cfg.logit_softcap)
    return _proj_out(params, o, cfg), (k, v)


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
