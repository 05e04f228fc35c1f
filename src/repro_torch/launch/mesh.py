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

#: why the options that wait for the rest of distribution (compute over
#: the model axis, the dry run) raise
MESH_ITEM = "ROADMAP Queue 1 item 7 (distribution), second half"
#: why the paged engine's options that do not run over a mesh yet raise
MESH_SERVE_ITEM = "ROADMAP Queue 1 item 13 (the paged engine's options over a mesh)"


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


@dataclasses.dataclass
class BoundMesh:
    """A :class:`Mesh` laid onto the process group: this rank's place in
    it and the group of every axis (``device_mesh``)."""

    mesh: Mesh
    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    rank: int
    device_type: str

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

    def group(self, axes):
        """The process group spanning ``axes`` through this rank; None when
        they hold one rank.  Several axes are one group only where they
        cover every axis of more than one rank (the whole world)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        wide = [a for a in axes if self.shape[a] > 1]
        if not wide:
            return None
        if len(wide) == 1:
            return self.device_mesh.get_group(wide[0])
        import torch.distributed as dist

        if set(wide) == {a for a in self.axis_names if self.shape[a] > 1}:
            return dist.group.WORLD
        raise NotImplementedError(f"a process group over {wide} of a {self.shape} mesh")


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
    return BoundMesh(mesh=mesh, device_mesh=dm, rank=dist.get_rank(), device_type=device_type)


__all__ = ["MESH_ITEM", "MESH_SERVE_ITEM", "BoundMesh", "Mesh", "bind", "make_debug_mesh", "make_mesh",
           "make_production_mesh", "make_serve_mesh"]
