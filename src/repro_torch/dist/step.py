"""Step builders, one device: the port of the JAX package's
``dist/step.py`` without its shardings.

A bundle carries the step function and its abstract inputs (``meta``
tensors: shapes and dtypes, no allocation), built when they are read, so
a step runs at any shape its model takes.  A shape is a name of
``configs.shapes.SHAPES`` or a ``ShapeCfg``::

    b = build_train_step(cfg, "train_4k")
    params, opt_state, loss, metrics = b.fn(params, opt_state, batch, step)

The train step is ``(params, opt_state, batch, step) -> (params,
opt_state, loss, metrics)``: the loss and its gradients by
``torch.autograd`` (every kernel schedule differentiates through its own
autograd function, whose backward launches kernels too), then
:func:`repro_torch.optim.adamw.update`, which writes the parameters and
moments in place (the port's counterpart of JAX's ``donate_argnums``).
The parameters are leaves that require gradients; the step marks them so.

FSDP and compressed gradients need a device mesh and wait for the
distributed slice (ROADMAP Queue 1 item 7): asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.shapes import ShapeCfg, input_specs, shape_of
from repro_torch.nn.spec import abstract_params
from repro_torch.optim import adamw

#: why the sharded options raise
MESH_ITEM = "ROADMAP Queue 1 item 7 (distribution)"


@dataclasses.dataclass(frozen=True)
class StepBundle:
    name: str
    fn: Callable
    inputs: Callable[[], tuple]  # () -> the abstract inputs
    loss_of: Callable | None = None  # a train step's (params, batch) -> loss

    @property
    def abstract_inputs(self) -> tuple:
        """``fn``'s inputs as ``meta`` tensors (trees of them), in order."""
        return self.inputs()


def _model_module(cfg):
    if cfg.family == "audio":
        from repro_torch.models import encdec

        return encdec
    from repro_torch.models import lm

    return lm


def _batch_specs(cfg, shape_name: str | ShapeCfg) -> dict:
    specs = input_specs(cfg, shape_name)
    return {k: v for k, v in specs.items()
            if k in ("tokens", "labels", "frames", "frontend_embeds")}


def _refuse_sharding(fsdp: bool, compress_pod_grads: bool = False) -> None:
    if fsdp:
        raise NotImplementedError(f"fsdp=True shards the parameters over a device mesh: "
                                  f"not ported yet, {MESH_ITEM}")
    if compress_pod_grads:
        raise NotImplementedError(f"compress_pod_grads=True compresses gradients across "
                                  f"pods: not ported yet, {MESH_ITEM}")


def value_and_grad(loss_of: Callable, params, batch) -> tuple[torch.Tensor, object]:
    """(loss, gradient tree) of ``loss_of(params, batch)``; every
    parameter is made a leaf that requires a gradient first."""
    leaves = tree.leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_of(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach (a front end's projection without
    # front-end inputs) has a zero gradient, as under jax.grad
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return loss.detach(), tree.map_structure(lambda _: next(it), params)


def build_train_step(cfg, shape_name: str | ShapeCfg, *, fsdp: bool = False,
                     compress_pod_grads: bool = False,
                     opt_cfg: adamw.AdamWConfig | None = None,
                     loss_chunk: int | None = 512) -> StepBundle:
    _refuse_sharding(fsdp, compress_pod_grads)
    mod = _model_module(cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def loss_of(params, batch):
        if "frames" in batch:
            return mod.loss_fn(params, cfg, batch["tokens"], batch["labels"], batch["frames"])
        kw = {}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        return mod.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                           loss_chunk=loss_chunk, **kw)

    def fn(params, opt_state, batch, step):
        loss, grads = value_and_grad(loss_of, params, batch)
        new_p, new_s, metrics = adamw.update(grads, opt_state, params, step, opt_cfg)
        return new_p, new_s, loss, metrics

    def inputs():
        abs_p = abstract_params(mod.model_spec(cfg))
        return (abs_p, adamw.abstract_state(abs_p, opt_cfg), _batch_specs(cfg, shape_name),
                torch.empty((), dtype=torch.int32, device="meta"))

    return StepBundle(name=f"train:{cfg.name}:{shape_of(shape_name).name}", fn=fn,
                      inputs=inputs, loss_of=loss_of)


def build_prefill_step(cfg, shape_name: str | ShapeCfg, *, fsdp: bool = False) -> StepBundle:
    _refuse_sharding(fsdp)
    mod = _model_module(cfg)

    def fn(params, batch):
        if "frames" in batch:
            return mod.prefill(params, cfg, batch["tokens"], batch["frames"])
        kw = {}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        return mod.prefill(params, cfg, batch["tokens"], **kw)

    return StepBundle(
        name=f"prefill:{cfg.name}:{shape_of(shape_name).name}", fn=fn,
        inputs=lambda: (abstract_params(mod.model_spec(cfg)), _batch_specs(cfg, shape_name)))


def build_decode_step(cfg, shape_name: str | ShapeCfg, *, fsdp: bool = False) -> StepBundle:
    _refuse_sharding(fsdp)
    mod = _model_module(cfg)

    def fn(params, cache, tokens, index):
        return mod.decode_step(params, cfg, cache, tokens, index)

    def inputs():
        specs = input_specs(cfg, shape_name)
        return (abstract_params(mod.model_spec(cfg)), specs["cache"], specs["tokens"],
                specs["index"])

    return StepBundle(name=f"decode:{cfg.name}:{shape_of(shape_name).name}", fn=fn,
                      inputs=inputs)


def build_step(cfg, shape_name: str | ShapeCfg, **kw) -> StepBundle:
    """Dispatch on the shape kind (train / prefill / decode)."""
    kind = shape_of(shape_name).kind
    if kind == "train":
        return build_train_step(cfg, shape_name, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, shape_name, **kw)
    return build_decode_step(cfg, shape_name, **kw)
