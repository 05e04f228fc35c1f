"""Encoder-decoder transformer (the whisper-medium backbone): the port of
the JAX package's ``models/encdec.py``.

The audio front end is a stub, as in the JAX package: the caller passes
precomputed frame embeddings (the output of whisper's two conv layers,
``cfg.encoder.n_frames`` of ``cfg.frontend_dim``).  The encoder projects
them to d_model, adds learned positions and runs bidirectional attention
layers; the decoder is a causal transformer with learned positions (at
the tokens' absolute positions) and cross attention to the encoder's
output.

Parameters are a dict: ``encoder`` (``proj``, ``pos``, ``layers``,
``final_norm``) and ``decoder`` (``embed``, ``pos``, ``layers``,
``final_norm``); each ``layers`` is a list of per-layer dicts — the JAX
package's stacked ``stage`` leaves, split — and the JAX ``lax.scan`` over
the stack becomes a Python loop.  Decode caches: per decoder layer a
self-attention :class:`KvCache` ring (updated in place) and the cross
attention's keys and values (:class:`CrossKv`), computed once from the
encoder's output at prefill.  The prefill's cross attention runs the
blockwise ``memeff_attention``, a decode step's the dense ``_attend``
over every frame, as in the JAX package: the two round differently.
Inside a model axis (:mod:`repro_torch.dist.tp`) the encoder and the
decoder compute over it as ``models/lm.py`` does: the rank's heads and
ff columns, a vocab-parallel embedding, head and cross entropy where the
vocabulary divides the axis.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT, resolve
from repro_torch.models import lm as lm_mod
from repro_torch.nn import attention as attn_mod
from repro_torch.nn.attention import KvCache
from repro_torch.nn.module import embed, embed_spec, positional_embed_spec, softcap, unembed
from repro_torch.nn.spec import ParamSpec, init_params, stacked


class CrossKv(NamedTuple):
    k: torch.Tensor  # (batch, frames, kv_heads, head_dim)
    v: torch.Tensor


def _enc_block_spec(cfg: ModelConfig):
    return {
        "norm1": lm_mod._norm_spec(cfg),
        "attn": attn_mod.attn_spec(cfg.d_model, cfg.attn),
        "norm2": lm_mod._norm_spec(cfg),
        "mlp": lm_mod.mlp_spec(cfg),
    }


def _dec_block_spec(cfg: ModelConfig):
    return {
        "norm1": lm_mod._norm_spec(cfg),
        "self_attn": attn_mod.attn_spec(cfg.d_model, cfg.attn),
        "norm_x": lm_mod._norm_spec(cfg),
        "cross_attn": attn_mod.attn_spec(cfg.d_model, cfg.attn),
        "norm2": lm_mod._norm_spec(cfg),
        "mlp": lm_mod.mlp_spec(cfg),
    }


def model_spec(cfg: ModelConfig):
    enc = cfg.encoder
    if enc is None:
        raise ValueError(f"{cfg.name} has no encoder: run it with models.lm")
    return {
        "encoder": {
            "proj": {"w": ParamSpec((cfg.frontend_dim, cfg.d_model), axes=(None, "embed"))},
            "pos": positional_embed_spec(enc.n_frames, cfg.d_model),
            "layers": [stacked(_enc_block_spec(cfg), enc.n_layers) for _ in range(enc.n_layers)],
            "final_norm": lm_mod._norm_spec(cfg),
        },
        "decoder": {
            "embed": embed_spec(cfg.vocab, cfg.d_model),
            "pos": positional_embed_spec(cfg.max_position, cfg.d_model),
            "layers": [stacked(_dec_block_spec(cfg), cfg.n_layers) for _ in range(cfg.n_layers)],
            "final_norm": lm_mod._norm_spec(cfg),
        },
    }


def init(cfg: ModelConfig, *, seed: int = 0, device: str | torch.device = DEFAULT):
    """Random parameters from ``seed`` (one ``torch.Generator`` per leaf)."""
    return init_params(model_spec(cfg), seed=seed, device=resolve(device))


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (batch, n_frames, frontend_dim) -> memory (batch, n_frames, d)."""
    p = params["encoder"]
    x = kernels.linear(frames, p["proj"]["w"], out_dtype=torch.bfloat16)
    x = x + p["pos"]["table"][:x.shape[1]][None].to(x.dtype)
    for bp in p["layers"]:
        h = lm_mod._norm(cfg, bp["norm1"], x)
        x = x + attn_mod.attention(bp["attn"], h, cfg.attn, causal=False)[0]
        h = lm_mod._norm(cfg, bp["norm2"], x)
        x = x + lm_mod.mlp(bp["mlp"], h, cfg)
    return lm_mod._norm(cfg, p["final_norm"], x)


def _dec_embed(params, cfg: ModelConfig, tokens: torch.Tensor, index=0) -> torch.Tensor:
    """Token embeddings plus the position rows ``index .. index + s - 1``
    (``index`` scalar, or (batch,) for ragged batches)."""
    p = params["decoder"]
    x = embed(p["embed"], tokens, vocab=cfg.vocab)
    idx = torch.as_tensor(index, device=x.device).reshape(-1).long()
    pos_ids = idx[:, None] + torch.arange(x.shape[1], device=x.device)[None, :]  # (1|b, s)
    return x + p["pos"]["table"][pos_ids].to(x.dtype)


def _dec_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return softcap(unembed(params["decoder"]["embed"], x, vocab=cfg.vocab), cfg.final_softcap)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor):
    """(batch, seq) tokens over (batch, n_frames, frontend_dim) frames ->
    ((batch, seq, vocab) fp32 logits, aux loss 0)."""
    memory = encode(params, cfg, frames)
    x = _dec_embed(params, cfg, tokens)
    for bp in params["decoder"]["layers"]:
        h = lm_mod._norm(cfg, bp["norm1"], x)
        x = x + attn_mod.attention(bp["self_attn"], h, cfg.attn, causal=True)[0]
        h = lm_mod._norm(cfg, bp["norm_x"], x)
        x = x + attn_mod.cross_attention(bp["cross_attn"], h, memory, cfg.attn)[0]
        h = lm_mod._norm(cfg, bp["norm2"], x)
        x = x + lm_mod.mlp(bp["mlp"], h, cfg)
    x = lm_mod._norm(cfg, params["decoder"]["final_norm"], x)
    return _dec_logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy on the fp32 logits (no chunking, as
    in the JAX package; its ``remat`` is not ported: no caller sets it)."""
    return lm_mod.cross_entropy(forward(params, cfg, tokens, frames)[0], labels,
                                vocab=cfg.vocab)


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> dict[str, Any]:
    """The decode caches' shapes and dtypes, allocating nothing (tensors on
    the ``meta`` device): per decoder layer a ``cache_len``-slot
    :class:`KvCache` and a :class:`CrossKv` over every frame."""
    kv, hd, frames = cfg.attn.n_kv_heads, cfg.attn.head_dim, cfg.encoder.n_frames

    def empty(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    n = cfg.n_layers
    return {
        "self": [KvCache(k=empty(batch, cache_len, kv, hd), v=empty(batch, cache_len, kv, hd),
                         pos=empty(batch, cache_len, dtype=torch.int32)) for _ in range(n)],
        "cross": [CrossKv(k=empty(batch, frames, kv, hd), v=empty(batch, frames, kv, hd))
                  for _ in range(n)],
    }


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor, *,
            cache_slots: int | None = None):
    """Encode, then the decoder over the prompt -> (the last position's
    logits (batch, 1, vocab), caches ``{"self": [KvCache], "cross":
    [CrossKv]}``).  ``cache_slots`` sizes the self-attention rings for
    decode (at least the prompt)."""
    memory = encode(params, cfg, frames)
    x = _dec_embed(params, cfg, tokens)
    b, s, _ = x.shape
    pad = max(cache_slots or s, s) - s
    positions = torch.arange(s, device=x.device, dtype=torch.int32).expand(b, s)
    caches = {"self": [], "cross": []}
    for bp in params["decoder"]["layers"]:
        h = lm_mod._norm(cfg, bp["norm1"], x)
        m, (k, v) = attn_mod.attention(bp["self_attn"], h, cfg.attn, causal=True)
        caches["self"].append(KvCache(
            k=torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            v=torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
            pos=torch.nn.functional.pad(positions, (0, pad), value=-1)))
        x = x + m
        h = lm_mod._norm(cfg, bp["norm_x"], x)
        m, (ck, cv) = attn_mod.cross_attention(bp["cross_attn"], h, memory, cfg.attn)
        caches["cross"].append(CrossKv(k=ck, v=cv))
        x = x + m
        h = lm_mod._norm(cfg, bp["norm2"], x)
        x = x + lm_mod.mlp(bp["mlp"], h, cfg)
    x = lm_mod._norm(cfg, params["decoder"]["final_norm"], x)
    return _dec_logits(params, cfg, x[:, -1:, :]), caches


def decode_step(params, cfg: ModelConfig, caches, tokens: torch.Tensor, index):
    """One decode step (or a few tokens) at absolute position ``index``
    (scalar, or (batch,) for ragged batches) against the caches of
    :func:`prefill`; the self-attention rings are updated in place.
    Returns (logits (batch, s_new, vocab), caches)."""
    x = _dec_embed(params, cfg, tokens, index=index)
    for bp, self_c, cross in zip(params["decoder"]["layers"], caches["self"], caches["cross"]):
        h = lm_mod._norm(cfg, bp["norm1"], x)
        m, _ = attn_mod.decode_attention(bp["self_attn"], h, self_c, cfg.attn, index=index)
        x = x + m
        h = lm_mod._norm(cfg, bp["norm_x"], x)
        x = x + cached_cross_attention(bp["cross_attn"], h, cross, cfg)
        h = lm_mod._norm(cfg, bp["norm2"], x)
        x = x + lm_mod.mlp(bp["mlp"], h, cfg)
    x = lm_mod._norm(cfg, params["decoder"]["final_norm"], x)
    return _dec_logits(params, cfg, x), caches


def cached_cross_attention(params, x: torch.Tensor, cross: CrossKv, cfg: ModelConfig):
    """Cross attention of a decode step over the cached keys and values:
    the dense ``_attend`` with every frame visible.  The query projection
    takes no bias, as in the JAX package (whisper has none)."""
    b, s = x.shape[0], x.shape[1]
    q = kernels.linear(x, params["wq"]).reshape(b, s, cfg.attn.n_heads, cfg.attn.head_dim)
    mask = torch.ones((b, 1, 1, s, cross.k.shape[1]), dtype=torch.bool, device=x.device)
    o = attn_mod._attend(q, cross.k, cross.v, mask, cfg.attn)
    return attn_mod._proj_out(params, o, cfg.attn)
