"""Griffin recurrent block: temporal conv + RG-LRU (recurrentgemma), the
port of the JAX package's ``nn/rglru.py``.

The RG-LRU recurrence (per channel)::

    r_t = sigmoid(x_t @ W_a + b_a)                  (recurrence gate)
    i_t = sigmoid(x_t @ W_x + b_x)                  (input gate)
    log a_t = -c * softplus(Lambda) * r_t           (c = 8, fixed)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block structure: two input branches d_model -> d_rnn; branch 1 is gated
(GeLU), branch 2 goes conv1d (width 4, causal, depthwise) -> RG-LRU; the
merged output is projected back to d_model.  Every projection goes
through ``kernels.linear`` (the two gates with their bias and sigmoid in
the epilogue and fp32 output).  The recurrence over a sequence is the
JAX package's ``jax.lax.associative_scan`` (:func:`associative_scan`, the
same combine tree: O(log s) rounds of whole-sequence ops), not the RG-LRU
kernel (K11).

States carry the batch on axis 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.configs.base import RglruConfig
from repro_torch.dist import tp
from repro_torch.nn.spec import ParamSpec
from repro_torch.nn.ssd import softplus


def rglru_spec(d_model: int, cfg: RglruConfig):
    d_rnn = cfg.d_rnn or d_model
    return {
        "w_gate_branch": ParamSpec((d_model, d_rnn), axes=("embed", "rnn")),
        "w_x_branch": ParamSpec((d_model, d_rnn), axes=("embed", "rnn")),
        "conv_w": ParamSpec((cfg.conv_width, d_rnn), axes=(None, "rnn")),
        "conv_b": ParamSpec((d_rnn,), init="zeros", axes=("rnn",)),
        "w_a": ParamSpec((d_rnn, d_rnn), axes=("rnn", "rnn_in")),
        "b_a": ParamSpec((d_rnn,), init="zeros", axes=("rnn",)),
        "w_i": ParamSpec((d_rnn, d_rnn), axes=("rnn", "rnn_in")),
        "b_i": ParamSpec((d_rnn,), init="zeros", axes=("rnn",)),
        "lam": ParamSpec((d_rnn,), dtype=torch.float32, init="normal", scale=0.5,
                         axes=("rnn",)),
        "w_out": ParamSpec((d_rnn, d_model), axes=("rnn", "embed")),
    }


class RglruState(NamedTuple):
    h: torch.Tensor  # (batch, d_rnn) fp32 recurrent state
    conv: torch.Tensor  # (batch, conv_width - 1, d_rnn) conv tail


def init_rglru_state(batch: int, d_model: int, cfg: RglruConfig, *, dtype=torch.bfloat16,
                     device) -> RglruState:
    d_rnn = cfg.d_rnn or d_model
    return RglruState(
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, d_rnn), dtype=dtype, device=device),
    )


def associative_scan(fn, elems: tuple[torch.Tensor, ...], dim: int = 1):
    """``jax.lax.associative_scan(fn, elems, axis=dim)``: the inclusive scan
    of the tuple ``elems`` under the associative ``fn(earlier, later)``,
    by the same recursion — combine the adjacent (even, odd) pairs, scan
    those recursively, combine each odd result with the next even
    element, and interleave — so every output is the same combine tree
    as JAX's, in O(log s) rounds."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems), tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd), tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        sl(full, 0, None, 2).copy_(torch.cat([sl(e, 0, 1), ev], dim=dim))
        sl(full, 1, None, 2).copy_(od)
        out.append(full)
    return tuple(out)


def _combine(c1, c2):
    """(a1, b1) then (a2, b2): ``a2 * b1 + b2`` as one fused multiply-add,
    as XLA compiles the JAX package's combine."""
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, torch.addcmul(b2, a2, b1)


def _causal_depthwise_conv(x, w, b, prefix=None):
    """x (b, s, d), w (width, d); ``prefix`` (b, width - 1, d) history."""
    width = w.shape[0]
    if prefix is None:
        prefix = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    return y + b, xp[:, -(width - 1):, :].clone()


def _gate(xb, w, bias, cut: bool):
    """``sigmoid(xb @ w + bias)`` in fp32; over the model axis (``cut``),
    ``xb`` and ``w``'s rows are this rank's channels: the fp32 partial
    products of every channel all-reduced, the rank's channels kept, then
    the bias and the sigmoid, as K1's epilogue adds them."""
    if not cut:  # the kernel's epilogue fuses bias + sigmoid
        return kernels.linear(xb, w, bias=bias, activation="sigmoid", out_dtype=torch.float32)
    from repro_torch.kernels.api import ACTIVATIONS

    y = tp.reduce_keep(kernels.linear(xb, w, out_dtype=torch.float32))
    return ACTIVATIONS["sigmoid"](y + bias.float())


def _gates(params, xb, cfg: RglruConfig, cut: bool = False):
    r = _gate(xb, params["w_a"], params["b_a"], cut)
    i = _gate(xb, params["w_i"], params["b_i"], cut)
    log_a = -cfg.c * softplus(params["lam"]) * r  # (b, s, d_rnn) fp32
    a = torch.exp(log_a)
    # 1 - a * a as XLA simplifies it: exp(x) * exp(x) -> exp(x + x)
    one_minus = 1.0 - torch.exp(log_a + log_a)
    gated_in = torch.sqrt(torch.clamp(one_minus, min=1e-12)) * (i * xb.float())
    return a, gated_in


def rglru(params, x, cfg: RglruConfig, *, state: RglruState | None = None):
    """Full-sequence Griffin block; x (b, s, d_model) -> (out, RglruState).
    Where the model axis holds this rank's RG-LRU channels
    (:mod:`repro_torch.dist.tp`): the branches column-parallel, the conv
    and the recurrence per channel, the gates over input-sharded
    ``w_a`` / ``w_i`` (:func:`_gate`), ``w_out`` row-parallel; the state
    holds the rank's channels."""
    cut = tp.split(params["w_x_branch"], 1, cfg.d_rnn or x.shape[-1])
    projs = [(params["w_gate_branch"], None, "gelu"), (params["w_x_branch"], None, None)]
    gate_branch, xb = tp.col_linears(x, projs) if cut else \
        [kernels.linear(x, w, activation=act) for w, _, act in projs]
    prefix = state.conv if state is not None else None
    xb, conv_tail = _causal_depthwise_conv(xb, params["conv_w"], params["conv_b"], prefix)

    a, gated_in = _gates(params, xb, cfg, cut)
    if state is not None:
        # seed the scan with the carried state through a virtual step
        gated_in = gated_in.clone()
        gated_in[:, 0, :] += a[:, 0, :] * state.h

    _, h = associative_scan(_combine, (a, gated_in), dim=1)
    new_state = RglruState(h=h[:, -1, :].clone(), conv=conv_tail)
    merged = gate_branch * h.to(x.dtype)
    if cut:
        return tp.row_linear(merged, params["w_out"]), new_state
    return kernels.linear(merged, params["w_out"]), new_state


def rglru_step(params, x, state: RglruState, cfg: RglruConfig):
    """Single-token decode; x (b, 1, d_model) -> (out, new RglruState)."""
    gate_branch = kernels.linear(x, params["w_gate_branch"], activation="gelu")
    xb = kernels.linear(x, params["w_x_branch"])
    xb, conv_tail = _causal_depthwise_conv(xb, params["conv_w"], params["conv_b"], state.conv)
    a, gated_in = _gates(params, xb, cfg)
    h = torch.addcmul(gated_in[:, 0], a[:, 0], state.h)  # (b, d_rnn) fp32, fused as XLA does
    y = kernels.linear(gate_branch[:, 0] * h.to(x.dtype), params["w_out"])
    return y[:, None, :], RglruState(h=h, conv=conv_tail)
