"""Decoder-only LM, dense family: the port of the JAX package's ``models/lm.py``.

Parameters are a dict: ``embed``, ``layers`` (a list with one dict per
layer — the JAX package's stacked ``stage0`` leaves, split) and
``final_norm``.  The JAX ``lax.scan`` over stacked layers becomes a
Python loop over the per-layer dicts.  Entry points:

* :func:`forward`     — full-sequence forward (no caches),
* :func:`prefill`     — full-sequence forward that also returns the
  per-layer dense K/V cache (``logit_index`` picks the row whose logits
  are returned, for bucket-padded prompts),
* :func:`prefill_to_pages` — scatter a batch-1 prefill cache into the
  page pools (in place),
* :func:`decode_step` — one (or a few) tokens against the page pools.

Only the configuration features of the dense family the paged serving
stack runs are ported; any other raises ``NotImplementedError`` naming
it (MoE, recurrent mixers, local windows, layernorm, learned positions,
front ends, post-block norms).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT, resolve
from repro_torch.nn import attention as attn_mod
from repro_torch.nn.attention import KvCache, PagedKvCache
from repro_torch.nn.module import (
    embed,
    embed_spec,
    rmsnorm,
    rmsnorm_spec,
    softcap,
    unembed,
)
from repro_torch.nn.spec import ParamSpec, init_params


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for configuration features the port
    does not run yet."""
    unsupported = {
        "moe": cfg.moe is not None,
        "ssm": cfg.ssm is not None,
        "rglru": cfg.rglru is not None,
        "encoder": cfg.encoder is not None,
        "frontend": bool(cfg.frontend),
        "norm=" + cfg.norm: cfg.norm != "rmsnorm",
        "post_block_norm": cfg.post_block_norm,
        "attn=None": cfg.attn is None,
        "learned_pos": cfg.attn is not None and cfg.attn.learned_pos,
    }
    for i, bd in enumerate(cfg.layer_defs):
        unsupported[f"layer {i} mixer={bd.mixer}"] = bd.mixer != "attn"
        unsupported[f"layer {i} window={bd.window}"] = bd.window is not None
        unsupported[f"layer {i} ff={bd.ff}"] = bd.ff != "mlp"
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense global-attention decoders only; "
            f"unsupported: {', '.join(bad)}")


def mlp_spec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    spec = {"w_in": ParamSpec((d, f)), "w_out": ParamSpec((f, d))}
    if cfg.glu:
        spec["w_gate"] = ParamSpec((d, f))
    return spec


def mlp(params, x, cfg: ModelConfig):
    """The activation rides K1's epilogue."""
    if cfg.glu:
        h = kernels.linear(x, params["w_gate"], activation=cfg.act) \
            * kernels.linear(x, params["w_in"])
    else:
        h = kernels.linear(x, params["w_in"], activation=cfg.act)
    return kernels.linear(h, params["w_out"])


def block_spec(cfg: ModelConfig):
    return {
        "norm1": rmsnorm_spec(cfg.d_model),
        "attn": attn_mod.attn_spec(cfg.d_model, cfg.attn),
        "norm2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg),
    }


def model_spec(cfg: ModelConfig):
    check_supported(cfg)
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg.vocab, cfg.d_model),
        "layers": [block_spec(cfg) for _ in range(cfg.n_layers)],
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = {"w": ParamSpec((cfg.d_model, cfg.vocab))}
    return spec


def init(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = DEFAULT):
    """Random parameters from ``seed`` (one ``torch.Generator`` per leaf)."""
    return init_params(model_spec(cfg), seed=seed, device=resolve(device))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_dtype: str = "bf16", *, device: str | torch.device = DEFAULT):
    """One page pool per layer, all indexed by the same host-managed
    block tables."""
    check_supported(cfg)
    if kv_dtype != "bf16":
        raise NotImplementedError(f"kv_dtype={kv_dtype!r}: the port's page pools are bf16")
    dev = resolve(device)
    return [attn_mod.init_paged_cache(num_pages, page_size, cfg.attn, device=dev)
            for _ in range(cfg.n_layers)]


def _embed_inputs(params, cfg: ModelConfig, tokens):
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = (x.float() * float(cfg.d_model) ** 0.5).to(x.dtype)
    return x


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        out = unembed(params["embed"], x)
    else:
        out = kernels.linear(x.float(), params["unembed"]["w"])
    return softcap(out, cfg.final_softcap)


def _mlp_half(p, cfg, x):
    return x + mlp(p["mlp"], rmsnorm(p["norm2"], x), cfg)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor):
    """(batch, seq) tokens -> ((batch, seq, vocab) fp32 logits, aux loss 0)."""
    x = _embed_inputs(params, cfg, tokens)
    for p in params["layers"]:
        m, _ = attn_mod.attention(p["attn"], rmsnorm(p["norm1"], x), cfg.attn)
        x = _mlp_half(p, cfg, x + m)
    x = rmsnorm(params["final_norm"], x)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_slots: int | None = None, logit_index=None):
    """Forward over the prompt -> (logits (b, 1, vocab), per-layer
    :class:`KvCache`).  ``cache_slots`` (>= prompt length) sizes the
    caches; ``logit_index`` (scalar or (b,)) picks the position whose
    logits are returned instead of the last — right-padded bucketed
    prompts read their true last token."""
    b, s = tokens.shape
    slots = max(cache_slots or s, s)
    x = _embed_inputs(params, cfg, tokens)
    caches = []
    for p in params["layers"]:
        m, (k, v) = attn_mod.attention(p["attn"], rmsnorm(p["norm1"], x), cfg.attn)
        pad = slots - s
        pos = torch.arange(s, device=x.device, dtype=torch.int32).expand(b, s)
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
        caches.append(KvCache(k=k, v=v, pos=pos))
        x = _mlp_half(p, cfg, x + m)
    x = rmsnorm(params["final_norm"], x)
    if logit_index is None:
        sel = x[:, -1:, :]
    else:
        li = torch.as_tensor(logit_index, device=x.device).reshape(-1).long().expand(b)
        sel = x[torch.arange(b, device=x.device), li][:, None, :]
    return _logits(params, cfg, sel), caches


def prefill_to_pages(dense_caches, paged_caches, block_table: torch.Tensor, length: int):
    """Scatter a batch-1 dense prefill cache into the page pools, in place.

    ``block_table``: (pages,) page ids covering ``[0, pages * page_size)``;
    rows past ``length`` (bucket padding) go to the null page 0, so the
    page bytes equal what the dense cache holds for the real tokens."""
    for dense_c, paged_c in zip(dense_caches, paged_caches):
        ps = paged_c.k_pages.shape[2]
        s_pad = dense_c.k.shape[1]
        pos = torch.arange(s_pad, device=block_table.device)
        valid = pos < length
        pidx = torch.clamp(pos // ps, 0, block_table.shape[0] - 1)
        ids = torch.where(valid, block_table.long()[pidx], torch.zeros_like(pos))
        rows = torch.where(valid, pos % ps, torch.zeros_like(pos))
        # (1, s_pad, kv, hd) -> (kv, s_pad, hd)
        paged_c.k_pages[:, ids, rows] = dense_c.k[0].transpose(0, 1).to(paged_c.k_pages.dtype)
        paged_c.v_pages[:, ids, rows] = dense_c.v[0].transpose(0, 1).to(paged_c.v_pages.dtype)
    return paged_caches


def decode_step(params, cfg: ModelConfig, caches, tokens: torch.Tensor, index, *,
                block_table: torch.Tensor, lengths: torch.Tensor):
    """One decode step (or a few: suffix prefills pass s_new > 1) against
    the page pools, which are updated in place.

    tokens: (batch, s_new); index: absolute position of the first new
    token (scalar or (batch,)); ``block_table`` (batch, pages) and
    ``lengths`` (batch,) = valid tokens after this call's writes.
    Returns (logits (batch, s_new, vocab), caches)."""
    x = _embed_inputs(params, cfg, tokens)
    for p, cache in zip(params["layers"], caches):
        if not isinstance(cache, PagedKvCache):
            raise NotImplementedError("decode_step: the port decodes against page pools only")
        m, _ = attn_mod.paged_decode_attention(
            p["attn"], rmsnorm(p["norm1"], x), cache, cfg.attn, index=index,
            block_table=block_table, lengths=lengths)
        x = _mlp_half(p, cfg, x + m)
    x = rmsnorm(params["final_norm"], x)
    return _logits(params, cfg, x), caches
