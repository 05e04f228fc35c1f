"""Basic layers: dense, norms, embeddings, rotary embeddings, softcap.

Plain functions over parameter dicts, mirroring the JAX package's
``nn/module.py``.  Compute dtype is bf16; norms and rope run in fp32.
Every projection-shaped matmul routes through ``kernels.linear`` (K1,
with the bias and activation fused into its epilogue).  The embedding
and the head are vocab-parallel inside a model axis
(:mod:`repro_torch.dist.tp`).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.dist import tp
from repro_torch.kernels import api
from repro_torch.nn.spec import ParamSpec


def dense_spec(d_in: int, d_out: int, *, axes=("embed", "ff")):
    return {"w": ParamSpec((d_in, d_out), axes=axes)}


def dense(params, x, *, activation: str | None = None):
    return kernels.linear(x, params["w"], bias=params.get("b"), activation=activation)


def rmsnorm_spec(d: int):
    # gemma-style (1 + scale) parameterisation, initialised to zeros
    return {"scale": ParamSpec((d,), dtype=torch.float32, init="zeros", axes=("embed",))}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


def layernorm_spec(d: int):
    return {"scale": ParamSpec((d,), dtype=torch.float32, init="ones", axes=("embed",)),
            "bias": ParamSpec((d,), dtype=torch.float32, init="zeros", axes=("embed",))}


def layernorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Mean and population variance in fp32 (``jnp.var``'s form: the mean
    of the squared deviations), one rounding to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def embed_spec(vocab: int, d: int):
    return {"table": ParamSpec((vocab, d), init="normal", scale=0.02, axes=("vocab", "embed"))}


def embed(params, tokens: torch.Tensor, *, vocab: int | None = None) -> torch.Tensor:
    """The table's rows of ``tokens``.  Where the model axis holds this
    rank's rows of a ``vocab``-row table (:mod:`repro_torch.dist.tp`), a
    vocab-parallel lookup: the rank's rows, zeros for tokens it does not
    hold, then one all-reduce (one nonzero term each: exact)."""
    table = params["table"]
    if vocab is None or not tp.split(table, 0, vocab):
        return table[tokens]
    start, n = tp.active().piece(vocab)
    local = tokens.long() - start
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    return tp.reduce_out(torch.where(mine[..., None], rows, torch.zeros_like(rows)))


def unembed(params, x: torch.Tensor, *, vocab: int | None = None) -> torch.Tensor:
    """Tied softmax head: fp32 logits.  K1 reads the bf16 table as a
    transposed view and widens it in registers — the same function as
    ``x.float() @ table.T.float()`` without materialising the fp32
    transposed table.  Where the model axis cuts a ``vocab``-row table,
    the logits of the rank's rows (:func:`head`)."""
    return head(x, params["table"].t(), vocab=vocab)


def head(x: torch.Tensor, w: torch.Tensor, *, vocab: int | None = None) -> torch.Tensor:
    """fp32 logits ``x @ w`` of a (d, vocab) head ``w``; where the model
    axis holds this rank's vocabulary columns of it, column-parallel: the
    rank's logits, the fp32 input's gradient summed over the axis."""
    xf = x.float()
    if vocab is not None and tp.split(w, 1, vocab):
        xf = tp.copy_in(xf)
    return kernels.linear(xf, w)


def positional_embed_spec(max_len: int, d: int):
    """A learned position table, ``{"table": (max_len, d)}``: the leaf that
    ``lm``'s and the encoder-decoder's ``pos`` keys hold."""
    return {"table": ParamSpec((max_len, d), init="normal", scale=0.02, axes=(None, "embed"))}


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings (half-split).  x: (..., seq, heads, head_dim),
    positions: broadcastable to (..., seq)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., seq, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str):
    """The activation applied outside a kernel, as the JAX package's
    ``act_fn`` applies ``jax.nn``'s: composed op by op in the input's
    dtype (``kernels.api.REFERENCE_ACTIVATIONS``), so bf16 rounds after
    every step as XLA's does."""
    return api.REFERENCE_ACTIVATIONS[name]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
