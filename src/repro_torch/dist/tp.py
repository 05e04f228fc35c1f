"""Compute over the model axis: the collectives of tensor parallelism as
``torch.autograd.Function``s, and the one seam every collective of a mesh
step passes through.

**The seam.**  Each collective a mesh step makes — the functions below,
``sharding.gather``'s ``all_gather``, the gradient mean, the MoE routing
fractions' mean (``dist/step.py``) and ``dist/mcast.py``'s rounds — calls
:func:`record`, which logs ``(op, axis, bytes, count, site)`` on every
active :class:`Recorder` (:func:`recording`).  ``op`` is HLO's name of
the collective: ``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all`` or ``collective-permute`` (a point-to-point round); its
bytes are HLO's too, the bytes of the result's shape on this rank;
``site`` says which caller made it.  On ``meta`` tensors (the dry run,
``launch/dryrun.py``) a collective sends nothing and returns a ``meta``
tensor of its result's shape, so no process group is needed.

**The model axis.**  Inside :func:`model_axis` (the mesh step enters it
with the ``model`` axis of its mesh, where that axis holds more than one
rank and does not carry the batch) the model functions receive this
rank's pieces of the parameters and see from a leaf's shape whether the
axis splits it (:func:`split`).  Where it does, they compute over the
rank's heads, feed-forward columns, experts, vocabulary rows or RG-LRU
channels, joined by Megatron's conjugate pair and two more:

* :func:`copy_in` (f): identity forward, all-reduce backward — a
  replicated tensor entering products that each rank computes for its
  own piece (a replicated weight a rank reads only in part; fp32 logits'
  input), so each rank's partial gradient is summed; the column-parallel
  projections of one input (:func:`col_linears`: q / k / v, gate / in)
  all-reduce their fp32 partial input gradients in one collective, each
  rounded once after it;
* :func:`reduce_out` (g): all-reduce forward, identity backward — the
  partial sums of a row-parallel product (:func:`row_linear`), a
  vocab-parallel lookup or a sum over the vocabulary;
* :func:`gather_out`: all-gather forward, this rank's slice backward —
  the router's logits of the rank's experts, gathered before routing;
* :func:`reduce_keep`: all-reduce forward, then this rank's slice;
  all-gather backward — a product over input-sharded weights whose
  output the rank keeps in part (RG-LRU's gates);
* :func:`all_max`: the vocab-parallel maximum, without a gradient.

Every tensor is then replicated (the same value and gradient on every
rank of the axis), a piece, or a partial sum, and each of these functions
moves between two of those.  All-reduces sum in fp32 and round once to
the tensor's dtype.  Outside :func:`model_axis`, or on an axis of one
rank, :func:`active` is None and every model function takes its
one-device path, bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

#: HLO's names of the collectives the recorder counts
HLO_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


class Recorder:
    """The seam's log: ``events`` of ``(op, axis, bytes, count, site)``.
    A region inside :func:`repeat` is counted as often as it says."""

    def __init__(self):
        self.events: list[list] = []
        self._marks: list[int] = []

    def log(self, op: str, axis: str, nbytes: int, count: int = 1, site: str = "") -> None:
        if op not in HLO_OPS:
            raise ValueError(f"unknown collective {op!r} (have {HLO_OPS})")
        self.events.append([op, axis, int(nbytes), count, site])

    def begin_repeat(self) -> None:
        self._marks.append(len(self.events))

    def end_repeat(self, n: int) -> None:
        for ev in self.events[self._marks.pop():]:
            ev[2] *= n
            ev[3] *= n

    def counts(self, *, op: str | None = None, axis: str | None = None,
               site: str | None = None) -> int:
        """Collectives logged, of ``op`` over ``axis`` from ``site`` (None: any)."""
        return sum(c for o, a, _, c, s in self.events
                   if (op is None or o == op) and (axis is None or a == axis)
                   and (site is None or s == site))


_RECORDERS: list[Recorder] = []


@contextlib.contextmanager
def recording(rec: Recorder | None = None):
    """Log every collective made inside on ``rec`` (a new
    :class:`Recorder` by default), which it yields."""
    rec = Recorder() if rec is None else rec
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def record(op: str, axis: str, nbytes: int, count: int = 1, site: str = "") -> None:
    for rec in _RECORDERS:
        rec.log(op, axis, nbytes, count, site)


@contextlib.contextmanager
def repeat(n: int):
    """What runs inside counts ``n`` times on every active recorder: the
    dry run runs one iteration of a loop of ``n`` identical iterations
    (on ``meta`` tensors), as HLO's analysis multiplies a loop body by its
    trip count."""
    recs = list(_RECORDERS)
    for r in recs:
        r.begin_repeat()
    try:
        yield
    finally:
        for r in reversed(recs):
            r.end_repeat(n)


class _Repeated(torch.autograd.Function):
    """``fn(*xs)`` once under :func:`repeat` (``n``), its backward too."""

    @staticmethod
    def forward(ctx, n, fn, *xs):
        ctx.n = n
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(x.requires_grad) for x in xs]
            with repeat(n):
                out = fn(*ins)
        ctx.ins, ctx.out = ins, out
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        want = [x for x in ctx.ins if x.requires_grad]
        with repeat(ctx.n):
            got = iter(torch.autograd.grad(ctx.out, want, g, allow_unused=True))
        return (None, None, *(next(got) if x.requires_grad else None for x in ctx.ins))


def repeated(n: int, fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn(*xs)`` (one tensor out) run once and counted as ``n`` runs,
    forward and backward: a loop of ``n`` identical iterations over
    ``meta`` tensors in the dry run.  It computes no values, so it is
    only for ``meta`` inputs."""
    if not all(x.is_meta for x in xs):
        raise ValueError("repeated() stands in for a loop only on meta tensors")
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _Repeated.apply(n, fn, *xs)
    with repeat(n):
        return fn(*xs)


# -- collectives --------------------------------------------------------------

def _bytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def all_reduce(x: torch.Tensor, axis: str, group, *, op: str = "sum",
               site: str = "", inplace: bool = False) -> torch.Tensor:
    """A new tensor (``inplace``: ``x`` itself, contiguous and the caller's
    own): ``x`` summed (or maxed) over ``group``, the ranks of ``axis``;
    one collective."""
    record("all-reduce", axis, _bytes(x.shape, x.dtype), site=site)
    if x.is_meta:
        return x if inplace else torch.empty_like(x)
    import torch.distributed as dist

    y = x if inplace else x.detach().contiguous().clone()  # autograd is the Functions' below
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return y


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group, axis: str,
                    site: str = "") -> None:
    """``out`` (n * x.shape[0], ...) <- every rank's ``x`` in group order:
    one collective."""
    record("all-gather", axis, _bytes(out.shape, out.dtype), site=site)
    if x.is_meta:
        return
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x.detach(), group=group)


def all_gather(x: torch.Tensor, axis: str, group, n: int, dim: int = 0,
               site: str = "") -> torch.Tensor:
    """Every rank's ``x`` laid end to end along ``dim``, in group order."""
    xm = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=x.dtype, device=x.device)
    all_gather_into(out, xm, group, axis, site)
    return out.movedim(0, dim)


# -- the model axis ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model axis as one rank sees it: ``n`` ranks, this one at
    ``index``, their process group (None on ``meta`` tensors)."""

    n: int
    index: int
    group: object = None
    name: str = "model"

    def piece(self, size: int) -> tuple[int, int]:
        """(start, length) of this rank's piece of a dimension of ``size``."""
        if size % self.n:
            raise ValueError(f"a dimension of {size} does not split over {self.n} ranks")
        k = size // self.n
        return self.index * k, k


_AXES: list[ModelAxis | None] = []


@contextlib.contextmanager
def model_axis(axis: ModelAxis | None):
    """Run the model functions inside over ``axis`` (None: one device)."""
    _AXES.append(axis)
    try:
        yield axis
    finally:
        _AXES.pop()


def active() -> ModelAxis | None:
    return _AXES[-1] if _AXES else None


def split(t: torch.Tensor, dim: int, full: int) -> bool:
    """Does the active model axis hold only a piece of ``t`` along ``dim``,
    whose full length is ``full``?"""
    return active() is not None and t.shape[dim] != full


def whole(params: dict, spec: dict, where: str, cut: dict | None = None) -> None:
    """Raise where the active model axis holds only a piece of a leaf of
    ``params`` (full shapes in ``spec``) along a dimension that ``where``
    does not compute over; ``cut`` names, per leaf, the one dimension it
    does (default: none).  The sharding rules' repair can move the axis
    to another dimension of a leaf (an expert count the axis does not
    divide puts it on ``ff``), and a function that read only one
    dimension's shape would then compute a wrong result silently."""
    for name, sp in spec.items():
        if name not in params or isinstance(sp, dict):
            continue
        dims = [i for i, (got, full) in enumerate(zip(params[name].shape, sp.shape))
                if got != full and i != (cut or {}).get(name)]
        if dims:
            raise NotImplementedError(
                f"{where}: the model axis cuts {name} {tuple(sp.shape)} along dimension "
                f"{dims[0]}, over which {where} does not compute")


def _sum32(x: torch.Tensor, ax: ModelAxis, site: str) -> torch.Tensor:
    return all_reduce(x.float(), ax.name, ax.group, site=site).to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.ax, "tp.copy_in"), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _sum32(x, ax, "tp.reduce_out")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.k = ax, dim, x.shape[dim]
        return all_gather(x, ax.name, ax.group, ax.n, dim, site="tp.gather_out").contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.k, ctx.k), None, None


class _ReduceKeep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        start, k = ax.piece(x.shape[dim])
        return _sum32(x, ax, "tp.reduce_keep").narrow(dim, start, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return all_gather(g, ax.name, ax.group, ax.n, ctx.dim,
                          site="tp.reduce_keep").contiguous(), None, None


def _axis() -> ModelAxis:
    ax = active()
    if ax is None:
        raise RuntimeError("no model axis is active (tp.model_axis)")
    return ax


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """f: identity forward; the gradient all-reduced (summed) backward."""
    return _CopyIn.apply(x, _axis())


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """g: the partial sums all-reduced forward; identity backward."""
    return _ReduceOut.apply(x, _axis())


def gather_out(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's piece along ``dim`` gathered forward; this rank's
    slice of the gradient backward."""
    return _GatherOut.apply(x, _axis(), dim % x.ndim)


def reduce_keep(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Partial sums all-reduced, then this rank's piece along ``dim``;
    the gradient all-gathered backward."""
    return _ReduceKeep.apply(x, _axis(), dim % x.ndim)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the axis (no gradient)."""
    ax = _axis()
    return all_reduce(x.detach(), ax.name, ax.group, op="max", site="tp.all_max")


class _ColLinears(torch.autograd.Function):
    """Column-parallel ``act_i(x @ w_i + bias_i)`` for projections that
    read one replicated ``x``: the forward is ``kernels.linear``'s; the
    backward is its matmul VJP (``kernels.api.matmul_vjp``) per
    projection, each dA left in fp32, all of them all-reduced in one
    collective, each then rounded once to ``x``'s dtype and summed."""

    @staticmethod
    def forward(ctx, x, ax, policy, acts, *wbs):
        from repro_torch import kernels

        ctx.ax, ctx.policy, ctx.acts = ax, policy, acts
        ctx.save_for_backward(x, *wbs)
        return tuple(kernels.linear(x, w, bias=bias, activation=act)
                     for w, bias, act in zip(wbs[::2], wbs[1::2], acts))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        from repro_torch import kernels
        from repro_torch.kernels.api import matmul_vjp

        x, *wbs = ctx.saved_tensors
        a, grads = x.reshape(-1, x.shape[-1]), []
        parts = a.new_empty((len(gs), *a.shape), dtype=torch.float32)
        for i, (w, bias, act, g) in enumerate(zip(wbs[::2], wbs[1::2], ctx.acts, gs)):
            parts[i], dw, dbias = matmul_vjp(kernels.linear, ctx.policy, act or "none", a, w,
                                             bias, g.reshape(-1, g.shape[-1]), da_fp32=True)
            grads += [dw, dbias]
        da = None
        if ctx.needs_input_grad[0]:
            # every projection's fp32 partial in one all-reduce (XLA's tuple
            # all-reduce); each then rounds once and they add up in x's
            # dtype, the last first, as one device's autograd adds them
            ax = ctx.ax
            *rest, last = all_reduce(parts, ax.name, ax.group, site="tp.col_linears",
                                     inplace=True).unbind(0)
            da = last.to(x.dtype)
            for d in reversed(rest):
                da = da + d.to(x.dtype)
            da = da.reshape(x.shape)
        return (da, None, None, None, *grads)


def col_linears(x: torch.Tensor, projs) -> tuple[torch.Tensor, ...]:
    """Column-parallel projections of one replicated ``x``: ``projs`` is
    ``(w, bias, activation)`` per projection, ``w`` and ``bias`` this
    rank's output columns; each output is ``act(x @ w + bias)``.  Their
    input's gradient is one all-reduce (Megatron's f: one collective for
    q / k / v or gate / in, as XLA's tuple all-reduce in JAX's step) of
    every projection's fp32 partial product; each projection's sum then
    rounds once, as one device's dA = dz w^T does, and they add up in the
    input's dtype as one device's autograd adds them."""
    from repro_torch import kernels
    from repro_torch.kernels.api import _bwd_policy_token

    projs = [(w, bias, act) for w, bias, act in projs]
    if not (torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                            for p in projs for t in (x, *p[:2]))):
        return tuple(kernels.linear(x, w, bias=bias, activation=act) for w, bias, act in projs)
    wbs = [t for w, bias, _ in projs for t in (w, bias)]
    return _ColLinears.apply(x, _axis(), _bwd_policy_token(kernels.get_policy()),
                             tuple(act for *_, act in projs), *wbs)


def row_linear(x: torch.Tensor, w: torch.Tensor, *, bias: torch.Tensor | None = None,
               activation: str | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """A row-parallel ``act(x @ w + bias)``: ``x`` and ``w`` this rank's
    pieces along the contracted dimension.  The rank's partial product in
    fp32 (``kernels.linear``, no bias), all-reduced in fp32; then the bias
    and the activation in fp32 and one rounding to ``out_dtype`` (default
    ``x.dtype``) — the rounding K1's epilogue makes on one device."""
    from repro_torch import kernels
    from repro_torch.kernels.api import ACTIVATIONS

    y = reduce_out(kernels.linear(x, w, out_dtype=torch.float32))
    if bias is not None:
        y = y + bias.float()
    if activation is not None:
        y = ACTIVATIONS[activation](y)
    return y.to(out_dtype or x.dtype)


def model_axis_of(mesh, batch_axes: tuple) -> ModelAxis | None:
    """The model axis a mesh step computes over: None where the mesh has
    no ``model`` axis of more than one rank, or where the batch spreads
    over it (an arch that leaves it idle)."""
    if mesh is None or "model" not in mesh.axis_names or mesh.shape["model"] == 1 \
            or "model" in batch_axes:
        return None
    return ModelAxis(n=mesh.shape["model"], index=mesh.coords["model"],
                     group=mesh.group("model"))


__all__ = ["HLO_OPS", "ModelAxis", "Recorder", "active", "all_gather", "all_gather_into",
           "all_max", "all_reduce", "col_linears", "copy_in", "gather_out", "model_axis",
           "model_axis_of", "record", "recording", "reduce_keep", "reduce_out", "repeat",
           "repeated", "row_linear", "split", "whole"]
