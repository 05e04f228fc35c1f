"""AdamW with optional bf16 moments: the port of the JAX package's
``optim/adamw.py``, as plain functions on tensor trees.

The numerics are JAX's, not ``torch.optim.AdamW``'s (whose decay and
rounding order differ):

* the schedule (linear warmup, then cosine decay) and the bias
  corrections ``1 - b**t`` are fp32 scalars computed from the int32 step;
* ``global_norm`` is the square root of a sum of per-leaf fp32 sums of
  squares, the leaves added one after the other in the tree's order (the
  JAX package adds them in ``jax.tree.leaves`` order — sorted dict keys —
  over its stacked layout, so the two sums run in other orders);
* each leaf's update runs in fp32 and rounds once to the parameter's
  dtype and once to ``moment_dtype``.

:func:`update` runs under ``torch.no_grad()`` and writes the parameters
and moments in place (the port's counterpart of JAX's buffer donation):
it returns the same tensors it was given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    m: Any  # first-moment tree
    v: Any  # second-moment tree


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype``, each beside its parameter."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    return AdamWState(m=tree.map_structure(zeros, params), v=tree.map_structure(zeros, params))


def abstract_state(param_tree, cfg: AdamWConfig) -> AdamWState:
    """The moments' shapes and dtypes on the ``meta`` device."""
    def z(p):
        return torch.empty(p.shape, dtype=cfg.moment_dtype, device="meta")
    return AdamWState(m=tree.map_structure(z, param_tree), v=tree.map_structure(z, param_tree))


def _step_tensor(step, device) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32, device=device)


def schedule(step, cfg: AdamWConfig, *, device=None) -> torch.Tensor:
    """Linear warmup -> cosine decay, fp32 (``step``: int or int32 tensor)."""
    step = _step_tensor(step, device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the per-leaf fp32 sums of squares, added in the tree's order."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    return torch.sqrt(sum(sums))


@torch.no_grad()
def update(grads, state: AdamWState, params, step, cfg: AdamWConfig, *,
           grad_norm: torch.Tensor | None = None):
    """One AdamW step, in place -> (params, state, {"grad_norm", "lr"}).
    ``grad_norm`` replaces ``global_norm(grads)`` where ``grads`` are one
    rank's shards of the gradient tree whose norm clips them."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    dev = gnorm.device
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, cfg, device=dev)
    t = _step_tensor(step, dev).float() + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=dev), t)

    def upd(p, g, m, v):
        g = g.float() * clip
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        decay = cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * (step_ + decay)).to(p.dtype))
        m.copy_(m32.to(cfg.moment_dtype))
        v.copy_(v32.to(cfg.moment_dtype))

    tree.map_structure(upd, params, grads, state.m, state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
