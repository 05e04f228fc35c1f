"""Mamba-2 block via the SSD (state-space duality) chunked algorithm: the
port of the JAX package's ``nn/ssd.py``.

Per head (head dim P, state dim N), with per-head scalar decay::

    a_t = exp(A * dt_t),  A = -exp(A_log)          (A_log learned, per head)
    H_t = a_t * H_{t-1} + (dt_t * x_t) (x) B_t     (outer product, P x N)
    y_t = H_t . C_t + D * x_t

Block layout: in_proj -> [z | x | B | C | dt]; causal depthwise conv over
[x|B|C]; the chunked SSD; gated RMSNorm (y * silu(z)); out_proj.  The two
projections go through ``kernels.linear`` (K1, K4 or K5 as dispatch
picks).  The chunk algebra is the JAX package's plain math, not the SSD
kernel (K9): the same einsums, each three-operand one written as two
products so that no (..., i, j, h, p) intermediate is built, and JAX's
``lax.scan`` over chunks as a Python loop that emits each chunk's
*incoming* state.  Op order and dtypes follow the JAX code: the conv is a
Python sum of bf16 products, the causal mask comes before the ``exp``,
``softplus`` is ``logaddexp(x, 0)`` and the activations are
``nn.module.act_fn``'s (composed as ``jax.nn`` composes them).

States carry the batch on axis 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.configs.base import SsmConfig
from repro_torch.dist import tp
from repro_torch.nn.module import act_fn, rmsnorm_spec
from repro_torch.nn.spec import ParamSpec


def _dims(d_model: int, cfg: SsmConfig):
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * cfg.d_state
    return d_inner, n_heads, conv_dim


def ssd_spec(d_model: int, cfg: SsmConfig):
    d_inner, n_heads, conv_dim = _dims(d_model, cfg)
    proj_out = 2 * d_inner + 2 * cfg.d_state + n_heads  # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d_model, proj_out), axes=("embed", "rnn")),
        "conv_w": ParamSpec((cfg.conv_width, conv_dim), axes=(None, "rnn")),
        "conv_b": ParamSpec((conv_dim,), init="zeros", axes=("rnn",)),
        "a_log": ParamSpec((n_heads,), dtype=torch.float32, init="normal", scale=0.5,
                           axes=("rnn",)),
        "dt_bias": ParamSpec((n_heads,), dtype=torch.float32, init="zeros", axes=("rnn",)),
        "d_skip": ParamSpec((n_heads,), dtype=torch.float32, init="ones", axes=("rnn",)),
        "norm": rmsnorm_spec(d_inner),
        "out_proj": ParamSpec((d_inner, d_model), axes=("rnn", "embed")),
    }


class SsdState(NamedTuple):
    h: torch.Tensor  # (batch, n_heads, head_dim, d_state) fp32
    conv: torch.Tensor  # (batch, conv_width - 1, conv_dim)


def init_ssd_state(batch: int, d_model: int, cfg: SsmConfig, *, dtype=torch.bfloat16,
                   device) -> SsdState:
    _, n_heads, conv_dim = _dims(d_model, cfg)
    return SsdState(
        h=torch.zeros((batch, n_heads, cfg.head_dim, cfg.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype, device=device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), NaN passed through (no threshold, unlike
    ``F.softplus``)."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def _split_proj(params, u, d_model, cfg: SsmConfig):
    d_inner, n_heads, _ = _dims(d_model, cfg)
    proj = kernels.linear(u, params["in_proj"])
    return torch.split(proj, [d_inner, d_inner, cfg.d_state, cfg.d_state, n_heads], dim=-1)


def _conv(params, xbc, prefix, return_padded: bool = False):
    w, bias = params["conv_w"], params["conv_b"]
    width = w.shape[0]
    if prefix is None:
        prefix = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                             device=xbc.device)
    xp = torch.cat([prefix, xbc], dim=1)
    y = sum(xp[:, i:i + xbc.shape[1], :] * w[i] for i in range(width))
    tail = xp if return_padded else xp[:, -(width - 1):, :]
    return act_fn("silu")(y + bias), tail


def _gated_norm(params, y, z, eps=1e-6):
    yf = y.float() * act_fn("silu")(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1.0 + params["norm"]["scale"])).to(y.dtype)


def ssd(params, u, cfg: SsmConfig, *, state: SsdState | None = None):
    """Full-sequence mamba2 block; u (b, s, d_model) -> (out, SsdState).

    A sequence the chunk does not divide is padded inside; padded steps
    get dt = 0 (no decay, no input), so outputs and the carried state are
    those of the unpadded sequence, and the conv tail is the last
    ``conv_width - 1`` *real* inputs."""
    bsz, s_real, d_model = u.shape
    if tp.active() is not None:  # no model-axis path
        tp.whole(params, ssd_spec(d_model, cfg), "ssd")
    d_inner, n_heads, _ = _dims(d_model, cfg)
    P, N, Q = cfg.head_dim, cfg.d_state, cfg.chunk
    pad = (-s_real) % Q
    s = s_real + pad
    nc = s // Q

    z, xs, b, c, dt = _split_proj(params, u, d_model, cfg)
    if pad:
        xs, b, c, dt = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (xs, b, c, dt))
    width = cfg.conv_width
    xbc, xp = _conv(params, torch.cat([xs, b, c], dim=-1),
                    state.conv if state is not None else None, return_padded=True)
    conv_tail = xp[:, s_real:s_real + width - 1].clone()  # not a view of the whole xp
    xs, b, c = torch.split(xbc, [d_inner, N, N], dim=-1)

    x_h = xs.reshape(bsz, s, n_heads, P).float()
    b_h, c_h = b.float(), c.float()  # (b, s, N): one group, shared by the heads
    dt = softplus(dt.float() + params["dt_bias"])  # (b, s, H)
    if pad:  # padded steps: no decay, no input -> the state passes through
        dt = dt * (torch.arange(s, device=u.device) < s_real)[None, :, None]
    log_a = dt * -torch.exp(params["a_log"])  # (b, s, H) per-step log decay

    # --- chunked SSD ---------------------------------------------------------
    xq = (dt[..., None] * x_h).reshape(bsz, nc, Q, n_heads, P)
    bq = b_h.reshape(bsz, nc, Q, N)
    cq = c_h.reshape(bsz, nc, Q, N)
    lcum = torch.cumsum(log_a.reshape(bsz, nc, Q, n_heads), dim=2)
    ltot = lcum[:, :, -1, :]  # (b, nc, H) full-chunk decay

    # intra-chunk: M[i, j] = (C_i . B_j) exp(l_i - l_j) for j <= i; the
    # mask comes before the exp (j > i would overflow)
    scores = torch.einsum("bkin,bkjn->bkij", cq, bq)
    seg = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (b, nc, i, j, H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  torch.full_like(seg, -1e30)))
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", scores[..., None] * decay, xq)

    # chunk summaries: S_k = sum_j exp(ltot - l_j) x_j (x) B_j  (b, nc, H, P, N)
    wj = torch.exp(ltot[:, :, None, :] - lcum)  # (b, nc, Q, H)
    s_chunk = torch.einsum("bkjhp,bkjn->bkhpn", wj[..., None] * xq, bq)

    # inter-chunk recurrence: H_k = exp(ltot_k) H_{k-1} + S_k (one fused
    # multiply-add, as XLA compiles it); chunk k reads its incoming state
    h = state.h if state is not None else torch.zeros((bsz, n_heads, P, N),
                                                      dtype=torch.float32, device=u.device)
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = torch.addcmul(s_chunk[:, k], torch.exp(ltot[:, k])[:, :, None, None], h)
    h_in = torch.stack(h_in, dim=1)  # (b, nc, H, P, N)

    # inter-chunk contribution: y_i += exp(lcum_i) C_i . H_in
    y_inter = torch.exp(lcum)[..., None] * torch.einsum("bkin,bkhpn->bkihp", cq, h_in)

    y = (y_intra + y_inter).reshape(bsz, s, n_heads, P)
    y = y + params["d_skip"][None, None, :, None] * x_h
    y = y.reshape(bsz, s, d_inner).to(u.dtype)
    if pad:
        y = y[:, :s_real]  # z is unpadded

    y = _gated_norm(params, y, z)
    out = kernels.linear(y, params["out_proj"])
    return out, SsdState(h=h, conv=conv_tail)


def ssd_step(params, u, state: SsdState, cfg: SsmConfig):
    """Single-token decode; u (b, 1, d_model) -> (out, new SsdState)."""
    bsz, _, d_model = u.shape
    d_inner, n_heads, _ = _dims(d_model, cfg)
    P, N = cfg.head_dim, cfg.d_state

    z, xs, b, c, dt = _split_proj(params, u, d_model, cfg)
    xbc, conv_tail = _conv(params, torch.cat([xs, b, c], dim=-1), state.conv)
    xs, b, c = torch.split(xbc[:, 0], [d_inner, N, N], dim=-1)

    x_h = xs.reshape(bsz, n_heads, P).float()
    dtv = softplus(dt[:, 0].float() + params["dt_bias"])  # (b, H)
    a = torch.exp(dtv * -torch.exp(params["a_log"]))  # (b, H)
    bf, cf = b.float(), c.float()  # (b, N)

    h = a[:, :, None, None] * state.h + (dtv[:, :, None] * x_h)[..., None] * bf[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, cf) + params["d_skip"][None, :, None] * x_h
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = _gated_norm(params, y, z)
    return kernels.linear(y, params["out_proj"]), SsdState(h=h, conv=conv_tail)
