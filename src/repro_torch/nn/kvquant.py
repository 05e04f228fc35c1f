"""int8-quantised KV caches: the port of the JAX package's ``nn/kvquant.py``.

Decode is bound by the bytes of K/V it reads; storing them as int8 with
one bf16 scale per (row, head) vector halves those bytes.  Two caches,
as in the JAX package:

* :class:`QuantKvCache` — the dense ring buffer (:func:`init_quant_cache`,
  :func:`quant_decode_attention`): new rows are quantised on the way
  in, the whole ring dequantised before the attention;
* :class:`QuantPagedKvCache` — the page pool (:func:`init_quant_paged_cache`,
  :func:`quant_paged_decode_attention`): new rows are quantised into
  their pages, and the int8 pools with their scales go to
  ``kernels.op("paged_attention")``, whose prefill schedule (K3)
  dequantises on the gather.

:func:`quantize_kv` rounds exactly as the JAX function does: the scale is
``max|x| / 127 + 1e-8`` in fp32, the values ``round(x / scale)`` in fp32
(half to even, as ``jnp.round``) clipped to [-127, 127], and only then
is the scale cast to bf16.  Caches are updated **in place**, as
``nn/attention.py``'s are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.configs.base import AttnConfig
from repro_torch.nn.attention import (
    KvCache,
    _attend,
    _proj_out,
    _qkv,
    paged_positions,
    paged_write,
    visible,
)


class QuantKvCache(NamedTuple):
    k: torch.Tensor  # (batch, slots, kv_heads, head_dim) int8
    v: torch.Tensor  # int8
    k_scale: torch.Tensor  # (batch, slots, kv_heads, 1) bf16
    v_scale: torch.Tensor
    pos: torch.Tensor  # (batch, slots) int32, -1 = empty


def init_quant_cache(batch: int, slots: int, cfg: AttnConfig, *, device) -> QuantKvCache:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return QuantKvCache(
        k=torch.zeros((batch, slots, kv, hd), dtype=torch.int8, device=device),
        v=torch.zeros((batch, slots, kv, hd), dtype=torch.int8, device=device),
        k_scale=torch.zeros((batch, slots, kv, 1), dtype=torch.bfloat16, device=device),
        v_scale=torch.zeros((batch, slots, kv, 1), dtype=torch.bfloat16, device=device),
        pos=torch.full((batch, slots), -1, dtype=torch.int32, device=device),
    )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) -> int8 values + a bf16 scale per vector (…, 1)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def quantize_cache(cache: KvCache) -> QuantKvCache:
    kq, ks = quantize_kv(cache.k)
    vq, vs = quantize_kv(cache.v)
    return QuantKvCache(k=kq, v=vq, k_scale=ks, v_scale=vs, pos=cache.pos)


def quant_decode_attention(params, x, cache: QuantKvCache, cfg: AttnConfig, *, index,
                           window: int | None = None):
    """:func:`~repro_torch.nn.attention.decode_attention` against an int8
    ring (same semantics: a position-explicit ring buffer, written in
    place)."""
    b, s_new = x.shape[0], x.shape[1]
    slots = cache.k.shape[1]
    index = torch.as_tensor(index, device=x.device).reshape(-1).long()
    positions = (index[:, None] + torch.arange(s_new, device=x.device)[None, :])
    positions = positions.expand(b, s_new)
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    kq_new, ks_new = quantize_kv(k_new)
    vq_new, vs_new = quantize_kv(v_new)
    write = positions % slots
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s_new)
    cache.k[bidx, write] = kq_new
    cache.v[bidx, write] = vq_new
    cache.k_scale[bidx, write] = ks_new
    cache.v_scale[bidx, write] = vs_new
    cache.pos[bidx, write] = positions.to(torch.int32)
    k = dequantize_kv(cache.k, cache.k_scale)
    v = dequantize_kv(cache.v, cache.v_scale)
    qp = positions[:, None, None, :, None]
    kp = cache.pos[:, None, None, None, :]
    o = _attend(q, k, v, visible(qp, kp, window), cfg)
    return _proj_out(params, o, cfg), cache


class QuantPagedKvCache(NamedTuple):
    """int8 page pool: :class:`~repro_torch.nn.attention.PagedKvCache`
    with a bf16 scale per (page, row, head)."""

    k_pages: torch.Tensor  # (kv_heads, num_pages, page_size, head_dim) int8
    v_pages: torch.Tensor
    k_scale: torch.Tensor  # (kv_heads, num_pages, page_size, 1) bf16
    v_scale: torch.Tensor


def init_quant_paged_cache(num_pages: int, page_size: int, cfg: AttnConfig, *,
                           device) -> QuantPagedKvCache:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return QuantPagedKvCache(
        k_pages=torch.zeros((kv, num_pages, page_size, hd), dtype=torch.int8, device=device),
        v_pages=torch.zeros((kv, num_pages, page_size, hd), dtype=torch.int8, device=device),
        k_scale=torch.zeros((kv, num_pages, page_size, 1), dtype=torch.bfloat16,
                            device=device),
        v_scale=torch.zeros((kv, num_pages, page_size, 1), dtype=torch.bfloat16,
                            device=device),
    )


def quant_paged_decode_attention(params, x, cache: QuantPagedKvCache, cfg: AttnConfig, *,
                                 index, block_table: torch.Tensor, lengths: torch.Tensor):
    """:func:`~repro_torch.nn.attention.paged_decode_attention` against
    int8 pages: the new K/V rows are quantised into their pages (in
    place), and the paged-attention op dequantises on the gather (the
    prefill schedule, K3, at every ``s_new``)."""
    ps = cache.k_pages.shape[2]
    positions, page_slot, rows, valid = paged_positions(
        x, index, lengths, ps, block_table.shape[1])
    q, k_new, v_new = _qkv(params, x, cfg, positions)
    page_ids = torch.where(valid, torch.gather(block_table.long(), 1, page_slot),
                           torch.zeros_like(page_slot))
    kq_new, ks_new = quantize_kv(k_new)
    vq_new, vs_new = quantize_kv(v_new)
    paged_write(cache.k_pages, kq_new, page_ids, rows)
    paged_write(cache.v_pages, vq_new, page_ids, rows)
    paged_write(cache.k_scale, ks_new, page_ids, rows)
    paged_write(cache.v_scale, vs_new, page_ids, rows)
    o = kernels.op("paged_attention")(
        q, cache.k_pages, cache.v_pages, block_table, positions[:, 0], lengths,
        cache.k_scale, cache.v_scale, softcap=cfg.logit_softcap,
    )
    return _proj_out(params, o, cfg), cache


def cache_bytes(cache) -> int:
    """Total bytes of a cache, a page pool, or a list of them."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return sum(cache_bytes(c) for c in cache)
