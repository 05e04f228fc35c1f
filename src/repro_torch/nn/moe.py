"""Mixture-of-experts with GShard-style one-hot einsum dispatch: the port
of the JAX package's ``nn/moe.py``.

1. router logits (fp32, through ``kernels.linear``) -> softcap ->
   softmax -> the top-k distinct experts per token, ties to the lower
   expert index as ``jax.lax.top_k`` breaks them (a stable descending
   sort: with a zero router every probability ties);
2. groups = sequences (the batch axis), regrouped into windows of
   ``group_size`` tokens where that divides the sequence; per-group
   capacity ``C = ceil(k * s * cf / E)`` (decode: s = 1 -> drop-free), the
   formula kept as written, float floor division and all, and groups of
   at most 64 slots take all of them;
3. slot-major position within each expert by a cumsum; slots past
   capacity drop (the residual path carries the token);
4. a dispatch tensor (b, k*s, E, C) feeds two einsums: tokens -> (b, E,
   C, d) expert buffers -> the expert matmuls (``kernels.grouped_linear``:
   one kernel launch over all E experts per projection) -> combine
   weighted by the gates, summed over the k slots.

Every expert runs on its whole buffer, empty slots included, as in the
JAX package: a decode step reads every expert's weights.  The dispatch
and combine einsums each take one token per output element, so bf16
rounds them exactly as JAX does; the k-slot sum accumulates in fp32 and
rounds once, as XLA's CPU reduce does.  JAX's ``_ep_constrain`` is a
sharding hint under a device mesh and has no counterpart here; over a
mesh whose batch splits over ranks, the train step passes ``ce_reduce``
(the aux loss's routing fractions averaged over the batch ranks).

Inside a model axis that holds this rank's experts
(:mod:`repro_torch.dist.tp`), the router's logits of those experts are
gathered before the softcap, the softmax and the top-k, so every rank
routes as one device does; the dispatch takes the rank's experts'
columns, ``grouped_linear`` runs over them, and the combine's fp32
partial sum is all-reduced with the shared expert's (column/row-parallel
over ``ff``), each then rounded once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import MoeConfig
from repro_torch.dist import tp
from repro_torch.nn.module import act_fn, softcap
from repro_torch.nn.spec import ParamSpec


def moe_spec(d_model: int, cfg: MoeConfig, *, glu: bool = True):
    e, f = cfg.n_experts, cfg.d_ff_expert
    spec = {
        "router": ParamSpec((d_model, e), dtype=torch.float32, axes=("embed", "expert")),
        "w_in": ParamSpec((e, d_model, f), axes=("expert", "embed", "ff")),
        "w_out": ParamSpec((e, f, d_model), axes=("expert", "ff", "embed")),
    }
    if glu:
        spec["w_gate"] = ParamSpec((e, d_model, f), axes=("expert", "embed", "ff"))
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * f
        spec["shared_in"] = ParamSpec((d_model, sf), axes=("embed", "ff"))
        spec["shared_out"] = ParamSpec((sf, d_model), axes=("ff", "embed"))
        if glu:
            spec["shared_gate"] = ParamSpec((d_model, sf), axes=("embed", "ff"))
    return spec


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values in ascending index order."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def capacity(k: int, s: int, e: int, capacity_factor: float) -> int:
    """Slots per expert in a routing group of ``s`` tokens (JAX's formula)."""
    cap = int(max(1, min(-(-k * s * capacity_factor // e), k * s)))
    return k * s if k * s <= 64 else cap


def moe(params, x: torch.Tensor, cfg: MoeConfig, *, act: str = "silu", glu: bool = True,
        ce_reduce=None):
    """x: (batch, seq, d) -> ((batch, seq, d), fp32 aux loss).

    ``ce_reduce``: where the batch is split over ranks, a function taking
    ``ce`` (the fraction of this rank's routed slots that went to each
    expert, fp32 (E,), no gradient) to its mean over the batch ranks, so
    the aux loss ``E * sum(me * ce)`` weighs this rank's ``me`` by the
    whole batch's routing, as JAX's one global program does; ``me`` stays
    local (the mean of the ranks' losses then averages it)."""
    b_orig, s_orig, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if tp.active() is not None:
        tp.whole(params, moe_spec(d, cfg, glu=glu), "moe",
                 cut={"router": 1, "w_in": 0, "w_gate": 0, "w_out": 0, "shared_in": 1,
                      "shared_gate": 1, "shared_out": 0})
    ep = tp.split(params["w_in"], 0, e)  # this rank's experts (dist/tp.py)

    # route within windows of group_size tokens (batch-major reshape)
    gs = max(1, min(cfg.group_size, s_orig))
    if s_orig % gs == 0 and gs < s_orig:
        x = x.reshape(b_orig * (s_orig // gs), gs, d)
    b, s, _ = x.shape

    xin = tp.copy_in(x) if ep else x  # what the dispatch reads (exact sums)
    # --- routing (fp32) ---------------------------------------------------
    if tp.split(params["router"], 1, e):  # the rank's experts' logits, gathered
        logits = tp.gather_out(kernels.linear(tp.copy_in(x.float()), params["router"]))
    else:
        logits = kernels.linear(x.float(), params["router"])
    logits = softcap(logits, cfg.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)  # (b, s, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_ids, e).float().mean(dim=(0, 1, 2))
    if ce_reduce is not None:
        ce = ce_reduce(ce)
    aux_loss = e * torch.sum(me * ce)

    # --- grouped dispatch (groups = sequences) ------------------------------
    cap = capacity(k, s, e, cfg.capacity_factor)
    oh = F.one_hot(expert_ids, e)  # (b, s, k, e)
    # slot-major event stream (slot 0 for all tokens, then slot 1, ...)
    oh_flat = oh.permute(0, 2, 1, 3).reshape(b, k * s, e)
    pos = torch.cumsum(oh_flat, dim=1) - 1  # position within expert
    pos_sel = torch.sum(pos * oh_flat, dim=-1)  # (b, k*s)
    keep = pos_sel < cap
    gates_flat = (gate_vals.permute(0, 2, 1).reshape(b, k * s) * keep).to(x.dtype)
    slot = pos_sel[..., None] == torch.arange(cap, device=x.device)  # one_hot, zero past cap
    dispatch = (oh_flat[..., None] * slot[..., None, :]).to(x.dtype) \
        * keep[..., None, None].to(x.dtype)  # (b, k*s, e, cap)

    if ep:  # the rank's experts' columns; each rank's gates reach its own
        e0, el = tp.active().piece(e)
        dispatch = dispatch[:, :, e0:e0 + el]
        gates_flat = tp.copy_in(gates_flat)
    x_slots = torch.cat([xin] * k, dim=1)  # slot-major (b, k*s, d)
    hidden = torch.einsum("bjec,bjd->becd", dispatch, x_slots)

    # --- expert computation (one grouped kernel launch per projection) -----
    h_in = kernels.grouped_linear(hidden, params["w_in"])
    if glu:
        h = kernels.grouped_linear(hidden, params["w_gate"], activation=act) * h_in
    else:
        h = act_fn(act)(h_in)
    out = kernels.grouped_linear(h, params["w_out"])  # (b, e, cap, d)

    # --- combine --------------------------------------------------------------
    combine = dispatch * gates_flat[..., None, None]
    y = torch.einsum("bjec,becd->bjd", combine, out)  # (b, k*s, d)
    if ep:  # the rank's slots' fp32 sum, all-reduced below
        y = y.reshape(b, k, s, d).float().sum(dim=1)
    else:
        y = y.reshape(b, k, s, d).sum(dim=1)

    # --- shared experts (always-on path) --------------------------------------
    if "shared_in" not in params:
        return (tp.reduce_out(y).to(x.dtype) if ep else y).reshape(b_orig, s_orig, d), aux_loss
    tp_ff = tp.split(params["shared_in"], 1, cfg.n_shared_experts * cfg.d_ff_expert)
    xf = x.reshape(b * s, d)
    projs = [(params["shared_in"], None, None)]
    if glu:
        projs.append((params["shared_gate"], None, act))
    s_in, *gate = tp.col_linears(xf, projs) if tp_ff else \
        [kernels.linear(xf, w, activation=a) for w, _, a in projs]
    s_in = gate[0] * s_in if glu else act_fn(act)(s_in)
    if not ep and not tp_ff:
        return (y + kernels.linear(s_in, params["shared_out"]).reshape(b, s, d)).reshape(
            b_orig, s_orig, d), aux_loss
    # the routed and the shared partial sums in one all-reduce, each then
    # rounded to the activation dtype before their sum, as on one device
    shared = kernels.linear(s_in, params["shared_out"],
                            out_dtype=torch.float32 if tp_ff else None).reshape(b, s, d)
    if ep and tp_ff:
        both = tp.reduce_out(torch.stack([y, shared]))
        y, shared = both[0].to(x.dtype), both[1].to(x.dtype)
    elif ep:
        y = tp.reduce_out(y).to(x.dtype)
    else:
        shared = tp.reduce_out(shared).to(x.dtype)
    return (y + shared).reshape(b_orig, s_orig, d), aux_loss
