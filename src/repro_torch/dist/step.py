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

**Over a mesh** (``mesh=``: a mesh bound by
:func:`repro_torch.launch.mesh.bind`, or for the dry run a seat on a
mesh with no process group, :func:`repro_torch.launch.mesh.seat`, whose
steps run on ``meta`` tensors only), each rank:

* holds its pieces of the parameters and moments, placed by
  :func:`repro_torch.dist.sharding.param_shardings` (``bundle.placements``;
  ``fsdp=True`` adds the data axis), and of ``err_state`` likewise;
  ``bundle.local_inputs()`` gives their shapes and dtypes;
* gathers its parameters over every axis but ``model`` before the
  forward (the FSDP fetch: one ``all_gather`` per leaf cut over data);
* computes over the model axis (:mod:`repro_torch.dist.tp`,
  ``bundle.model_axis``): every rank of that axis holds and computes only
  its heads, feed-forward columns, experts, vocabulary rows and RG-LRU
  channels, as GSPMD partitions the JAX package's step over the same
  shardings — where the axis has one rank, or carries the batch (an arch
  that leaves it idle), the ranks compute the one-device step;
* computes the loss on its rows of the batch
  (:func:`repro_torch.data.pipeline.sharded_batch` over
  ``bundle.batch_axes``); in a MoE arch each layer's routing fractions
  ``ce`` are all-reduced to their mean over the batch ranks before the
  aux loss takes them (``bundle.ce_reduce``), so the mean of the ranks'
  losses is the whole batch's loss, as JAX's one global program computes
  it for equal row counts;
* all-reduces its gradient pieces (summed in fp32, divided by the rank
  count, rounded once to each leaf's dtype) and the loss to their means
  over the batch ranks; a leaf the model axis cuts keeps its gradient
  piece;
* takes the global norm of the whole gradient (each leaf's sum of
  squares added over the model axis where it is cut: the one-device
  value), and updates its own pieces.  With compression the gradient
  pieces are first gathered over the model axis, since the blocks run
  over the whole leaf, and each rank keeps its piece after.

With ``mesh=None``, or a mesh of one rank, the step is the one-device
step, bit for bit (on one rank the ``ce`` all-reduce is still made, and
sums one term).  Every collective passes the seam of
:mod:`repro_torch.dist.tp`, where a recorder counts it.

``build_prefill_step(cfg, shape, mesh=)`` splits the batch over
``batch_axes`` and computes over the model axis the same way.  It returns
this rank's pieces: the logits of its batch rows, ``(b / n_batch, 1,
vocab / n_model)`` where the model axis cuts the vocabulary (else the
whole vocabulary), and its rows of the caches — an attention ring holds
the kv heads the rank computed (its own, or where the kv heads
replicate, those its query heads read), an RG-LRU state the rank's
channels.  :func:`gather_logits` gathers the logits.
``build_decode_step(cfg, shape, mesh=)`` runs replicated on each rank, as
JAX's decode step does (its ``in_shardings`` is None): every rank holds
and computes the whole step; ``fsdp`` has no effect there, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.configs.shapes import ShapeCfg, input_specs, shape_of
from repro_torch.dist import sharding, tp
from repro_torch.dist.compression import compress_grads
from repro_torch.nn.spec import abstract_params
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class StepBundle:
    name: str
    fn: Callable
    inputs: Callable[[], tuple]  # () -> the abstract inputs
    loss_of: Callable | None = None  # a train step's (params, batch) -> loss
    placements: object = None  # the Placement tree over its mesh
    batch_axes: tuple = ()  # the mesh axes the batch rows split over
    ce_reduce: object = None  # a MoE train step's BatchMean over its mesh
    model_axis: object = None  # the tp.ModelAxis the step computes over
    local: Callable[[], tuple] | None = None  # () -> this rank's abstract inputs

    @property
    def abstract_inputs(self) -> tuple:
        """``fn``'s inputs as ``meta`` tensors (trees of them), in order."""
        return self.inputs()

    def local_inputs(self) -> tuple:
        """``fn``'s inputs as one rank of its mesh holds them: ``meta``
        tensors of each input's per-rank shape and dtype (the whole
        inputs without a mesh)."""
        return self.inputs() if self.local is None else self.local()


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


def _local_batch(batch: dict, n_batch: int) -> dict:
    """The batch's ``meta`` specs cut to one rank's rows."""
    return {k: torch.empty((v.shape[0] // n_batch, *v.shape[1:]), dtype=v.dtype,
                           device="meta") for k, v in batch.items()}


def _check_mesh(mesh) -> None:
    if not hasattr(mesh, "group"):
        raise TypeError("mesh= takes a bound mesh (repro_torch.launch.mesh.bind) or a "
                        "seat (repro_torch.launch.mesh.seat)")


def _keep(axis) -> tuple:
    """The axes a step's parameters stay cut over: ``model`` where it
    computes over that axis."""
    return () if axis is None else (axis.name,)


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


def _axes_name(axes) -> str:
    return "+".join(axes)


def _mean_over(leaves: list[torch.Tensor], group, n: int, axes=("data",)) -> list[torch.Tensor]:
    """Each leaf's mean over the ``n`` ranks of ``group`` (the mesh axes
    ``axes``): one fp32 all-reduce over the leaves laid end to end, then
    one rounding back."""
    flat = torch.cat([x.float().reshape(-1) for x in leaves])
    flat = tp.all_reduce(flat, _axes_name(axes), group, site="step.mean") / n
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

    def __init__(self, group, n: int, axes=("data",)):
        self.group, self.n, self.axes, self.calls = group, n, axes, 0

    def __call__(self, ce: torch.Tensor) -> torch.Tensor:
        out = tp.all_reduce(ce.detach(), _axes_name(self.axes), self.group,
                            site="step.ce_reduce")
        self.calls += 1
        return out / self.n


def _ce_reduce(cfg, group, n_batch: int, axes) -> BatchMean | None:
    """The routing-fraction mean a MoE step over ``mesh`` passes to the
    loss: over the batch ranks' group; on a one-rank world, over that one
    rank; None for a dense arch, and where the batch axes hold one rank of
    a larger world (every rank then holds the whole batch's fractions)."""
    import torch.distributed as dist

    if cfg.moe is None:
        return None
    if n_batch > 1:
        return BatchMean(group, n_batch, axes)
    one = dist.is_initialized() and dist.get_world_size() == 1
    return BatchMean(None, 1, axes) if one else None


def _cut_norm(grads, placements, axis) -> torch.Tensor:
    """The global norm of a gradient tree whose leaves the model axis may
    cut: each leaf's fp32 sum of squares, those of cut leaves summed over
    the axis (one all-reduce), then added in the tree's order as
    :func:`repro_torch.optim.adamw.global_norm` adds them."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    cut = [i for i, pl in enumerate(tree.leaves(placements)) if axis.name in pl.spec]
    if cut:
        total = tp.all_reduce(torch.stack([sums[i] for i in cut]), axis.name, axis.group,
                              site="step.norm")
        for j, i in enumerate(cut):
            sums[i] = total[j]
    return torch.sqrt(sum(sums))


def build_train_step(cfg, shape_name: str | ShapeCfg, *, mesh=None, fsdp: bool = False,
                     compress_pod_grads: bool = False,
                     opt_cfg: adamw.AdamWConfig | None = None,
                     loss_chunk: int | None = 512) -> StepBundle:
    mod = _model_module(cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    shape = shape_of(shape_name)

    placements, ba, group, n_batch, ce_reduce, axis = None, (), None, 1, None, None
    if mesh is not None:
        _check_mesh(mesh)
        placements = sharding.param_shardings(cfg, mod.model_spec(cfg), mesh, fsdp=fsdp)
        ba = sharding.batch_axes(mesh, shape.global_batch, cfg)
        group, n_batch = (mesh.group(ba), mesh.size(ba)) if ba else (None, 1)
        ce_reduce = _ce_reduce(cfg, group, n_batch, ba)
        axis = tp.model_axis_of(mesh, ba)
    keep = _keep(axis)

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
        if placements is None:
            loss, grads = value_and_grad(loss_of, params, batch)
        else:
            with tp.model_axis(axis):
                mine = sharding.gather_tree(params, placements, mesh, keep=keep)
                loss, grads = value_and_grad(loss_of, mine, batch)
        if n_batch > 1:
            loss, *leaves = _mean_over([loss, *tree.leaves(grads)], group, n_batch, ba)
            it = iter(leaves)
            grads = tree.map_structure(lambda _: next(it), grads)
        if placements is None:
            if err_state is not None:
                grads, err_state = compress_grads(grads, err_state)
            return loss, grads, None, err_state
        if err_state is not None:
            # the blocks run over whole leaves: gather the model pieces
            grads = sharding.gather_tree(grads, placements, mesh, cut=keep)
            err = sharding.gather_tree(err_state, placements, mesh)
            grads, err = compress_grads(grads, err)
            err_state = sharding.shard_tree(err, placements, mesh)
            return (loss, sharding.shard_tree(grads, placements, mesh),
                    adamw.global_norm(grads), err_state)
        gnorm = adamw.global_norm(grads) if axis is None else \
            _cut_norm(grads, placements, axis)
        return loss, sharding.shard_tree(grads, placements, mesh, cut=keep), gnorm, None

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

    def inputs(pieces: bool = False):
        abs_p = abstract_params(mod.model_spec(cfg))
        if pieces:
            abs_p = sharding.local_tree(abs_p, placements, mesh)
        head = (abs_p, adamw.abstract_state(abs_p, opt_cfg))
        if compress_pod_grads:
            head += (tree.map_structure(
                lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), abs_p),)
        batch = _batch_specs(cfg, shape_name)
        return (*head, _local_batch(batch, n_batch) if pieces else batch,
                torch.empty((), dtype=torch.int32, device="meta"))

    return StepBundle(name=f"train:{cfg.name}:{shape.name}", fn=fn, inputs=inputs,
                      loss_of=loss_of, placements=placements, batch_axes=ba,
                      ce_reduce=ce_reduce, model_axis=axis,
                      local=None if mesh is None else (lambda: inputs(True)))


def build_prefill_step(cfg, shape_name: str | ShapeCfg, *, mesh=None,
                       fsdp: bool = False) -> StepBundle:
    """The prefill step: ``(params, batch) -> (logits, caches)``; over a
    mesh, this rank's pieces of both (the module's docstring)."""
    mod = _model_module(cfg)
    shape = shape_of(shape_name)
    placements, ba, n_batch, axis = None, (), 1, None
    if mesh is not None:
        _check_mesh(mesh)
        placements = sharding.param_shardings(cfg, mod.model_spec(cfg), mesh, fsdp=fsdp)
        ba = sharding.batch_axes(mesh, shape.global_batch, cfg)
        n_batch = mesh.size(ba) if ba else 1
        axis = tp.model_axis_of(mesh, ba)

    def run(params, batch):
        if "frames" in batch:
            return mod.prefill(params, cfg, batch["tokens"], batch["frames"])
        kw = {}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        return mod.prefill(params, cfg, batch["tokens"], **kw)

    def fn(params, batch):
        if placements is None:
            return run(params, batch)
        with tp.model_axis(axis):
            return run(sharding.gather_tree(params, placements, mesh, keep=_keep(axis)), batch)

    def inputs(pieces: bool = False):
        abs_p = abstract_params(mod.model_spec(cfg))
        batch = _batch_specs(cfg, shape_name)
        if pieces:
            return sharding.local_tree(abs_p, placements, mesh), _local_batch(batch, n_batch)
        return abs_p, batch

    return StepBundle(name=f"prefill:{cfg.name}:{shape.name}", fn=fn, inputs=inputs,
                      placements=placements, batch_axes=ba, model_axis=axis,
                      local=None if mesh is None else (lambda: inputs(True)))


def build_decode_step(cfg, shape_name: str | ShapeCfg, *, mesh=None,
                      fsdp: bool = False) -> StepBundle:
    """The decode step: ``(params, cache, tokens, index) -> (logits,
    cache)``.  Over a mesh it runs replicated, as JAX's does: every rank
    holds the whole inputs and computes the whole step; ``mesh`` and
    ``fsdp`` are taken for JAX's signature and change nothing."""
    del fsdp
    if mesh is not None:
        _check_mesh(mesh)
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


def gather_logits(bundle: StepBundle, logits: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """A mesh prefill's logits, every rank's piece gathered: the vocabulary
    over the model axis where it is cut, then the rows over the batch
    axes (row-major over them, as ``sharded_batch`` deals the rows)."""
    axis = bundle.model_axis
    if axis is not None and logits.shape[-1] != vocab:
        logits = tp.all_gather(logits, axis.name, axis.group, axis.n, logits.ndim - 1,
                               site="step.gather_logits")
    if bundle.batch_axes:
        ba = bundle.batch_axes
        logits = tp.all_gather(logits, _axes_name(ba), mesh.group(ba), mesh.size(ba), 0,
                               site="step.gather_logits")
    return logits.contiguous()
