"""Step builders: the port of the JAX package's ``dist/step.py``.

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
With ``compress_pod_grads=True`` it is ``(params, opt_state, err_state,
batch, step) -> (params, opt_state, err_state, loss, metrics)``: the
gradients pass through :func:`repro_torch.dist.compression.compress_grads`
before the update, as in the JAX package.

**Over a mesh** (``mesh=``, a mesh bound by
:func:`repro_torch.launch.mesh.bind`), each rank:

* holds its pieces of the parameters and moments, placed by
  :func:`repro_torch.dist.sharding.param_shardings` (``bundle.placements``;
  ``fsdp=True`` adds the data axis), and of ``err_state`` likewise;
* gathers the full parameters before the forward (one ``all_gather``
  per sharded dimension: the ``hw`` mode's collective, the FSDP fetch);
* computes the loss on its rows of the batch
  (:func:`repro_torch.data.pipeline.sharded_batch` over
  ``bundle.batch_axes``); in a MoE arch each layer's routing fractions
  ``ce`` are all-reduced to their mean over the batch ranks before the
  aux loss takes them (``bundle.ce_reduce``), so the mean of the ranks'
  losses is the whole batch's loss, as JAX's one global program computes
  it for equal row counts;
* all-reduces the gradients (summed in fp32, divided by the rank count,
  rounded once to each leaf's dtype) and the loss to their means over
  the batch ranks, so every rank holds the full mean gradient;
* compresses the full gradient leaves when asked (the blocks run over
  the whole leaf), takes the global norm of the full tree (the
  one-device value), and updates its own pieces.

The port shards **storage** over the model axis and gathers on use:
ranks along ``model`` compute the same rows unless ``batch_axes``
spreads the batch over that axis (small recurrent models).  Computing
over the model axis (column/row-parallel projections, a vocab-parallel
cross entropy), as GSPMD partitions the JAX package's compiled step, is
a later item (ROADMAP Queue 1 item 7, second half).  With ``mesh=None``,
or a mesh of one rank, the step is the one-device step, bit for bit (on
one rank the ``ce`` all-reduce is still made, and sums one term).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.shapes import ShapeCfg, input_specs, shape_of
from repro_torch.dist import sharding
from repro_torch.dist.compression import compress_grads
from repro_torch.launch.mesh import MESH_ITEM
from repro_torch.nn.spec import abstract_params
from repro_torch.optim import adamw



@dataclasses.dataclass(frozen=True)
class StepBundle:
    name: str
    fn: Callable
    inputs: Callable[[], tuple]  # () -> the abstract inputs
    loss_of: Callable | None = None  # a train step's (params, batch) -> loss
    placements: object = None  # a train step's Placement tree over its mesh
    batch_axes: tuple = ()  # the mesh axes a train step's batch rows split over
    ce_reduce: object = None  # a MoE train step's BatchMean over its mesh

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


def _refuse_sharding(fsdp: bool) -> None:
    if fsdp:
        raise NotImplementedError(f"fsdp=True for a serving step shards its parameters over "
                                  f"a device mesh: not ported yet, {MESH_ITEM}")


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


def _mean_over(leaves: list[torch.Tensor], group, n: int) -> list[torch.Tensor]:
    """Each leaf's mean over the ``n`` ranks of ``group``: one fp32
    all-reduce over the leaves laid end to end, then one rounding back."""
    import torch.distributed as dist

    flat = torch.cat([x.float().reshape(-1) for x in leaves])
    dist.all_reduce(flat, group=group)
    flat /= n
    out, i = [], 0
    for x in leaves:
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


class BatchMean:
    """A MoE layer's routing fractions ``ce`` -> their mean over the ``n``
    ranks of ``group`` (None: the default group, which then holds this
    rank alone): one fp32 all-reduce a call, made on one rank too.
    ``calls`` counts the all-reduces."""

    def __init__(self, group, n: int):
        self.group, self.n, self.calls = group, n, 0

    def __call__(self, ce: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = ce.detach().clone()
        dist.all_reduce(out, group=self.group)
        self.calls += 1
        return out / self.n


def _ce_reduce(cfg, group, n_batch: int) -> BatchMean | None:
    """The routing-fraction mean a MoE step over ``mesh`` passes to the
    loss: over the batch ranks' group; on a one-rank world, over that one
    rank; None for a dense arch, and where the batch axes hold one rank of
    a larger world (every rank then holds the whole batch's fractions)."""
    import torch.distributed as dist

    if cfg.moe is None:
        return None
    if n_batch > 1:
        return BatchMean(group, n_batch)
    return BatchMean(None, 1) if dist.get_world_size() == 1 else None


def build_train_step(cfg, shape_name: str | ShapeCfg, *, mesh=None, fsdp: bool = False,
                     compress_pod_grads: bool = False,
                     opt_cfg: adamw.AdamWConfig | None = None,
                     loss_chunk: int | None = 512) -> StepBundle:
    mod = _model_module(cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    shape = shape_of(shape_name)

    placements, ba, group, n_batch, ce_reduce = None, (), None, 1, None
    if mesh is not None:
        if not hasattr(mesh, "group"):
            raise TypeError("mesh= takes a bound mesh (repro_torch.launch.mesh.bind)")
        placements = sharding.param_shardings(cfg, mod.model_spec(cfg), mesh, fsdp=fsdp)
        ba = sharding.batch_axes(mesh, shape.global_batch, cfg)
        group, n_batch = (mesh.group(ba), mesh.size(ba)) if ba else (None, 1)
        ce_reduce = _ce_reduce(cfg, group, n_batch)

    def loss_of(params, batch):
        if "frames" in batch:
            return mod.loss_fn(params, cfg, batch["tokens"], batch["labels"], batch["frames"])
        kw = {}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        if ce_reduce is not None:
            kw["ce_reduce"] = ce_reduce
        return mod.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                           loss_chunk=loss_chunk, **kw)

    def grads_step(params, batch, err_state):
        full = params if placements is None else sharding.gather_tree(params, placements, mesh)
        loss, grads = value_and_grad(loss_of, full, batch)
        if n_batch > 1:
            loss, *leaves = _mean_over([loss, *tree.leaves(grads)], group, n_batch)
            it = iter(leaves)
            grads = tree.map_structure(lambda _: next(it), grads)
        if err_state is not None:
            err = err_state if placements is None else \
                sharding.gather_tree(err_state, placements, mesh)
            grads, err = compress_grads(grads, err)
            err_state = err if placements is None else \
                sharding.shard_tree(err, placements, mesh)
        if placements is None:
            return loss, grads, None, err_state
        # every rank holds the full mean gradient: its norm is the
        # one-device value, and each rank updates its own pieces
        gnorm = adamw.global_norm(grads)
        return loss, sharding.shard_tree(grads, placements, mesh), gnorm, err_state

    if compress_pod_grads:
        def fn(params, opt_state, err_state, batch, step):
            loss, grads, gnorm, err_state = grads_step(params, batch, err_state)
            new_p, new_s, metrics = adamw.update(grads, opt_state, params, step, opt_cfg,
                                                 grad_norm=gnorm)
            return new_p, new_s, err_state, loss, metrics
    else:
        def fn(params, opt_state, batch, step):
            loss, grads, gnorm, _ = grads_step(params, batch, None)
            new_p, new_s, metrics = adamw.update(grads, opt_state, params, step, opt_cfg,
                                                 grad_norm=gnorm)
            return new_p, new_s, loss, metrics

    def inputs():
        abs_p = abstract_params(mod.model_spec(cfg))
        head = (abs_p, adamw.abstract_state(abs_p, opt_cfg))
        if compress_pod_grads:
            head += (tree.map_structure(
                lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), abs_p),)
        return (*head, _batch_specs(cfg, shape_name),
                torch.empty((), dtype=torch.int32, device="meta"))

    return StepBundle(name=f"train:{cfg.name}:{shape.name}", fn=fn, inputs=inputs,
                      loss_of=loss_of, placements=placements, batch_axes=ba,
                      ce_reduce=ce_reduce)


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
