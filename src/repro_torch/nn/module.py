"""Basic layers: dense, rmsnorm, embeddings, rotary embeddings, softcap.

Plain functions over parameter dicts, mirroring the JAX package's
``nn/module.py``.  Compute dtype is bf16; norms and rope run in fp32.
Every projection-shaped matmul routes through ``kernels.linear`` (K1,
with the bias and activation fused into its epilogue).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.nn.spec import ParamSpec


def dense(params, x, *, activation: str | None = None):
    return kernels.linear(x, params["w"], bias=params.get("b"), activation=activation)


def rmsnorm_spec(d: int):
    # gemma-style (1 + scale) parameterisation, initialised to zeros
    return {"scale": ParamSpec((d,), dtype=torch.float32, init="zeros")}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return y.to(x.dtype)


def embed_spec(vocab: int, d: int):
    return {"table": ParamSpec((vocab, d), init="normal", scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied softmax head: fp32 logits.  K1 reads the bf16 table as a
    transposed view and widens it in registers — the same function as
    ``x.float() @ table.T.float()`` without materialising the fp32
    transposed table."""
    return kernels.linear(x.float(), params["table"].t())


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


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
