"""Sharding rules: logical parameter axes -> mesh axes, with repairs — the
port of the JAX package's ``dist/sharding.py``.

The spec tree tags every parameter dimension with a *logical* axis name
("vocab", "heads", "ff", "expert", "rnn", ...; ``nn/spec.py``).  This
module maps those to mesh axes per architecture and repairs the raw
mapping so it is always valid:

* a dimension whose size does not divide the mesh axis replicates
  (whisper's 51865-token vocab on a 16-way model axis),
* one mesh axis is never used twice in a spec (MoE weights shard
  experts over "model"; the ff dim then replicates),
* small recurrent models opt out of tensor parallelism entirely and
  instead spread the batch over the idle model axis.

A spec is a tuple with one mesh-axis name or ``None`` per *logical*
dimension of one layer's leaf (``PartitionSpec``'s entries).  The JAX
package stacks a stage's layers into one leaf whose leading "layers"
dimension never shards; its rules still see that dimension (its length
counts toward ``_FSDP_MIN_ELEMS``), so the port applies them to the same
stacked view (``ParamSpec.stack``) and drops the leading entry: a
layer's spec here is JAX's spec of its stage's leaf without its first
entry, and every other leaf's spec is JAX's.

``param_pspecs`` needs only ``mesh.shape`` / ``mesh.axis_names`` (tests
pass a :class:`repro_torch.launch.mesh.Mesh` with no devices);
``param_shardings`` adds FSDP weight sharding over the data axis when
asked — the multicast weight-distribution path: weights are gathered on
use.  It returns a :class:`Placement` per leaf.  The stored layout merges
logical dimensions (a headed projection is ``(d, heads * head_dim)``), so
a placement is said on the logical view, where ``torch.distributed``'s
``Shard(dim)`` would need one dimension per mesh axis: :func:`shard`
cuts a rank's piece of a full tensor through that view and :func:`gather`
rebuilds the full tensor from the pieces with one ``all_gather`` per
sharded dimension over that axis' group.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.dist import tp
from repro_torch.nn.spec import ParamSpec

# Tensor-parallel rnn sharding only pays off above this width; smaller
# recurrent models run without TP.
_RNN_TP_MIN_D_MODEL = 2048

# FSDP shards only leaves at least this large (norm scales etc. stay
# replicated — the gather would cost more than the memory saved).
_FSDP_MIN_ELEMS = 4096


def _rnn_rule(cfg) -> str | None:
    if cfg.rglru is None and cfg.ssm is None:
        return None
    return "model" if cfg.d_model >= _RNN_TP_MIN_D_MODEL else None


def logical_rules(cfg, mesh) -> dict[str, str | None]:
    """Logical axis -> mesh axis for this architecture."""
    del mesh  # rules are mesh-shape independent; repairs are per-tensor
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "expert": "model",
        "rnn": _rnn_rule(cfg),
        "rnn_in": None,
        "embed": None,
        "layers": None,
    }


def _uses_model_axis(cfg, rules) -> bool:
    """Does any parameter actually shard over "model" for this arch?"""
    if cfg.attn is not None or cfg.moe is not None or cfg.d_ff > 0:
        return True
    return rules.get("rnn") is not None


def batch_axes(mesh, global_batch: int, cfg=None) -> tuple[str, ...]:
    """Mesh axes the batch dimension shards over.

    Architectures that leave the model axis idle (small recurrent
    models) spread the batch over it too.  Falls back to plain data
    parallelism when the batch does not divide."""
    axes = ("data",)
    if cfg is not None and not _uses_model_axis(cfg, logical_rules(cfg, mesh)):
        if "model" in getattr(mesh, "axis_names", ()):
            axes = ("data", "model")
    sizes = dict(mesh.shape)
    usable = tuple(a for a in axes if a in sizes)
    n = math.prod(sizes[a] for a in usable) or 1
    if global_batch % n != 0:  # uneven batch: shrink to the data axis
        usable = ("data",) if "data" in sizes else ()
    return usable


def _stacked_view(spec: ParamSpec) -> tuple[tuple[int, ...], tuple]:
    """The leaf as the JAX package's rules see it: its logical shape and
    axes, with the stage's "layers" dimension in front for a layer."""
    if spec.stack is None:
        return spec.logical_shape, spec.logical_axes
    return (spec.stack, *spec.logical_shape), ("layers", *spec.logical_axes)


def _unstack(spec: ParamSpec, entries: list) -> tuple:
    return tuple(entries[1:] if spec.stack is not None else entries)


def _repair_entries(shape, logical_axes, rules: dict, mesh_sizes: dict) -> list:
    entries = []
    used: set[str] = set()
    for dim, logical in zip(shape, logical_axes):
        axis = rules.get(logical)
        if axis is None or axis not in mesh_sizes:
            entries.append(None)
            continue
        if axis in used or dim % mesh_sizes[axis] != 0:
            entries.append(None)  # duplicate use / non-divisible: replicate
            continue
        used.add(axis)
        entries.append(axis)
    return entries


def _fsdp_entries(shape, logical_axes, entries: list, mesh_sizes: dict) -> list:
    if "data" not in mesh_sizes or math.prod(shape) < _FSDP_MIN_ELEMS:
        return entries
    if "data" in entries:
        return entries
    # shard the largest still-replicated non-layer dim over "data"
    order = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
    for d in order:
        if entries[d] is None and logical_axes[d] != "layers" \
                and shape[d] % mesh_sizes["data"] == 0:
            return entries[:d] + ["data"] + entries[d + 1:]
    return entries


def _repair(spec: ParamSpec, rules: dict, mesh_sizes: dict) -> tuple:
    shape, axes = _stacked_view(spec)
    return _unstack(spec, _repair_entries(shape, axes, rules, mesh_sizes))


def _add_fsdp(spec: ParamSpec, ps: tuple, mesh_sizes: dict) -> tuple:
    shape, axes = _stacked_view(spec)
    entries = ([None] if spec.stack is not None else []) + list(ps)
    return _unstack(spec, _fsdp_entries(shape, axes, entries, mesh_sizes))


def _map_specs(fn, spec_tree):
    if isinstance(spec_tree, ParamSpec):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    return [_map_specs(fn, v) for v in spec_tree]


def param_pspecs(cfg, spec_tree, mesh, *, fsdp: bool = False):
    """The spec tree of a model spec tree (pure, no devices); ``fsdp``
    adds the FSDP entries of :func:`param_shardings`."""
    rules, sizes = logical_rules(cfg, mesh), dict(mesh.shape)
    return _map_specs(lambda s: _spec(s, rules, sizes, fsdp), spec_tree)


def _spec(s: ParamSpec, rules: dict, sizes: dict, fsdp: bool) -> tuple:
    ps = _repair(s, rules, sizes)
    return _add_fsdp(s, ps, sizes) if fsdp else ps


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a mesh: ``spec`` over its logical
    dimensions ``dims``; ``shape`` is how the full leaf is stored."""

    spec: tuple
    dims: tuple[int, ...]
    shape: tuple[int, ...]

    def local_dims(self, mesh_sizes: dict) -> tuple[int, ...]:
        """The logical dims of one rank's piece."""
        return _dims(self, mesh_sizes, set(self.spec))

    def local_shape(self, mesh_sizes: dict) -> tuple[int, ...]:
        """The stored shape of one rank's piece."""
        return _stored(self, self.local_dims(mesh_sizes))


def _groups(dims: tuple, shape: tuple) -> list[int]:
    """How many logical dims each stored dim merges, in order."""
    out, i = [], 0
    for n in shape:
        k, acc = 1, dims[i] if i < len(dims) else 0
        while acc < n and i + k < len(dims):
            acc *= dims[i + k]
            k += 1
        if acc != n:
            raise ValueError(f"stored shape {shape} does not merge logical dims {dims}")
        out.append(k)
        i += k
    if any(d != 1 for d in dims[i:]):
        raise ValueError(f"stored shape {shape} does not merge logical dims {dims}")
    if out:
        out[-1] += len(dims) - i  # trailing unit dims join the last stored dim
    return out


def param_shardings(cfg, spec_tree, mesh, *, fsdp: bool = False):
    """A :class:`Placement` tree; ``fsdp=True`` adds weight sharding over
    the data axis (weights are then gathered on use — the multicast
    distribution path the paper accelerates)."""
    rules, sizes = logical_rules(cfg, mesh), dict(mesh.shape)
    return _map_specs(
        lambda s: Placement(_spec(s, rules, sizes, fsdp), s.logical_shape, s.shape), spec_tree)


def _wide(pl: Placement, sizes: dict, axes=None) -> list[tuple[int, str]]:
    """(logical dim, mesh axis) of every dim cut over an axis of more than
    one rank (and in ``axes``, where given)."""
    return [(d, a) for d, a in enumerate(pl.spec)
            if a is not None and sizes[a] > 1 and (axes is None or a in axes)]


def _dims(pl: Placement, sizes: dict, cut) -> tuple[int, ...]:
    """The logical dims of a piece cut over the axes in ``cut``."""
    return tuple(n // sizes[a] if a is not None and a in cut else n
                 for n, a in zip(pl.dims, pl.spec))


def _stored(pl: Placement, dims: tuple[int, ...]) -> tuple[int, ...]:
    out, i = [], 0
    for group in _groups(pl.dims, pl.shape):
        out.append(math.prod(dims[i:i + group]))
        i += group
    return tuple(out)


def local_tree(abstract_tree, placements, mesh):
    """``meta`` tensors of one rank's pieces of an abstract tree (the
    parameters, or a state shaped like them; each leaf keeps its dtype):
    what the step and the dry run hand a rank.  Every rank's piece has
    the same shape, since a spec cuts only dimensions its axis divides."""
    sizes = dict(mesh.shape)
    return tree.map_structure(
        lambda x, pl: torch.empty(pl.local_shape(sizes), dtype=x.dtype, device="meta"),
        abstract_tree, placements)


def shard(x: torch.Tensor, pl: Placement, mesh, *, cut=()) -> torch.Tensor:
    """The piece the rank at ``mesh.coords`` holds, from ``x``: the leaf
    already cut over the axes in ``cut`` (none: the full leaf).  A
    contiguous copy; ``x`` itself where nothing more is cut."""
    sizes, coords = dict(mesh.shape), mesh.coords
    todo = [(d, a) for d, a in _wide(pl, sizes) if a not in cut]
    if not todo:
        return x
    y = x.reshape(_dims(pl, sizes, set(cut)))
    for d, a in todo:
        n = pl.dims[d] // sizes[a]
        y = y.narrow(d, coords[a] * n, n)
    return y.contiguous().reshape(pl.local_shape(sizes))


def gather(x: torch.Tensor, pl: Placement, mesh, *, cut=None, keep=()) -> torch.Tensor:
    """The leaf from every rank's piece: ``x`` cut over the axes in ``cut``
    (None: every axis of its spec, a rank's stored piece) is gathered over
    each of them but those in ``keep``, one ``all_gather`` over each cut
    dimension's axis (``mesh`` a bound mesh; on ``meta`` pieces, the
    seam's shapes alone).  The mesh step keeps the model axis: its ranks
    compute on their pieces."""
    sizes = dict(mesh.shape)
    have = set(pl.spec) if cut is None else set(cut)
    todo = [(d, a) for d, a in _wide(pl, sizes, have) if a not in keep]
    if not todo:
        return x
    y = x.reshape(_dims(pl, sizes, have))
    for d, a in todo:
        y = tp.all_gather(y, a, mesh.group(a), sizes[a], d, site="sharding.gather")
    return y.contiguous().reshape(_stored(pl, _dims(pl, sizes, set(keep) & have)))


def shard_tree(full_tree, placements, mesh, *, cut=()):
    return tree.map_structure(lambda x, pl: shard(x, pl, mesh, cut=cut), full_tree, placements)


def gather_tree(local_tree_, placements, mesh, *, cut=None, keep=()):
    return tree.map_structure(lambda x, pl: gather(x, pl, mesh, cut=cut, keep=keep),
                              local_tree_, placements)


__all__ = ["Placement", "batch_axes", "gather", "gather_tree", "local_tree", "logical_rules",
           "param_pspecs", "param_shardings", "shard", "shard_tree"]
