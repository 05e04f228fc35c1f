"""Mesh builders: the port of the JAX package's ``launch/mesh.py``.

A :class:`Mesh` is a shape and its axis names, usable with no device and
no process group at all (the JAX package's tests build fake meshes the
same way): the sharding rules of ``dist/sharding.py`` read only
``mesh.shape`` and ``mesh.axis_names``.  The builders are functions, so
importing this module touches no device.

Mesh shapes mirror the paper's hierarchy limit: physical crossbars top
out at 16 x 16, so scale-up goes hierarchical — the axes are capped at
16 and the pod axis adds the second level (2 pods x 256 devices).

:func:`bind` lays a mesh onto an initialised ``torch.distributed``
process group of the same size, as a ``DeviceMesh`` with the same axis
names: rank ``r`` sits at the row-major coordinates of ``r`` (the last
axis fastest), as ``jax.make_mesh`` lays devices out.  A group on
``cuda`` is NCCL's, one on ``cpu`` gloo's (:mod:`repro_torch.dist.spawn`
starts one).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in order; no devices."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs {self.axis_sizes}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """Rank -> its coordinate on every axis, row-major."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = rank % n
            rank //= n
        return {name: out[name] for name in self.axis_names}


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2, *, pod: int | None = None) -> Mesh:
    """Small mesh for CPU tests (``data * model`` gloo ranks)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


def make_serve_mesh(num_shards: int = 4, *, axis: str = "data") -> Mesh:
    """1-D mesh the sharded serving engine partitions its page pool over:
    ``num_shards`` devices along one named axis."""
    return make_mesh((num_shards,), (axis,))


class _Seat:
    """A :class:`Mesh` seen from one rank: its coordinates and sizes."""

    mesh: Mesh
    rank: int

    @property
    def shape(self) -> dict[str, int]:
        return self.mesh.shape

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.mesh.axis_names

    @property
    def coords(self) -> dict[str, int]:
        return self.mesh.coords(self.rank)

    def size(self, axes) -> int:
        """Ranks along ``axes`` (a name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (the first one major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i


@dataclasses.dataclass
class DryMesh(_Seat):
    """One rank's seat on a :class:`Mesh` with no process group: the dry
    run's (``launch/dryrun.py``).  Its groups are None; the collectives of
    :mod:`repro_torch.dist.tp` then run only on ``meta`` tensors."""

    mesh: Mesh
    rank: int = 0

    def group(self, axes):
        return None


def seat(mesh: Mesh, rank: int = 0) -> DryMesh:
    """Rank ``rank``'s seat on ``mesh``, without a process group."""
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    return DryMesh(mesh, rank)


@dataclasses.dataclass
class BoundMesh(_Seat):
    """A :class:`Mesh` laid onto the process group: this rank's place in
    it and the group of every axis (``device_mesh``)."""

    mesh: Mesh
    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    rank: int
    device_type: str
    subgroups: dict = dataclasses.field(default_factory=dict)  # axes -> group

    def group(self, axes):
        """The process group spanning ``axes`` through this rank; None when
        they hold one rank.  A group over one axis is ``device_mesh``'s;
        over several (but not every wide axis: the world), it is one of
        the groups :func:`bind` made for that set of axes, one for each
        coordinate of the other axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        wide = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        if not wide:
            return None
        if len(wide) == 1:
            return self.device_mesh.get_group(wide[0])
        import torch.distributed as dist

        if set(wide) == {a for a in self.axis_names if self.shape[a] > 1}:
            return dist.group.WORLD
        return self.subgroups[wide]


def _subgroups(mesh: Mesh, rank: int) -> dict[tuple[str, ...], object]:
    """This rank's process group over every set of two or more wide axes
    short of all of them: ``dist.new_group`` once for each coordinate of the
    other axes, every rank creating every group in the same order (a
    collective call), and keeping the one that holds it."""
    import itertools

    import torch.distributed as dist

    wide = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    coords = [mesh.coords(r) for r in range(mesh.size)]
    out = {}
    for k in range(2, len(wide)):
        for axes in itertools.combinations(wide, k):
            others = [a for a in mesh.axis_names if a not in axes]
            keys = sorted({tuple(c[a] for a in others) for c in coords})
            for key in keys:
                members = [r for r, c in enumerate(coords)
                           if tuple(c[a] for a in others) == key]
                g = dist.new_group(ranks=members)
                if rank in members:
                    out[axes] = g
    return out


def bind(mesh: Mesh) -> BoundMesh:
    """Lay ``mesh`` onto the initialised default process group, whose size
    must be ``mesh.size``: NCCL's puts the mesh on ``cuda``, gloo's on
    ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("bind(mesh) needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"a {mesh.shape} mesh needs {mesh.size} ranks, the group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, mesh.axis_sizes, mesh_dim_names=mesh.axis_names)
    rank = dist.get_rank()
    return BoundMesh(mesh=mesh, device_mesh=dm, rank=rank, device_type=device_type,
                     subgroups=_subgroups(mesh, rank))


__all__ = ["BoundMesh", "DryMesh", "Mesh", "bind", "make_debug_mesh", "make_mesh",
           "make_production_mesh", "make_serve_mesh", "seat"]
