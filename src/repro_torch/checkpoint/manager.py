"""Checkpoint / restore with a manifest and atomic writes: the port of the
JAX package's ``checkpoint/manager.py``, in its on-disk format.

* step-granular checkpoints, written atomically (a tmp dir, then a
  rename), so a failure mid-write never corrupts the restore point;
* ``step_%08d/arrays.npz`` holds one array per leaf path (``a/b/0/c``:
  dict keys, list indices and NamedTuple fields joined by ``/``) and
  ``step_%08d/manifest.json`` the ``step``, ``time``, ``leaves``,
  ``dtypes`` and ``meta``;
* restore checks the structure against a template before it builds a
  tensor (``KeyError`` on a missing leaf);
* keep-last-k garbage collection.

**Elastic restore**, as in the JAX package: leaves are saved
mesh-agnostic, as full logical arrays.  A sharded run saves by gathering
every leaf from its pieces (``save(..., mesh=, placements=)``: every
rank calls it, rank 0 writes), and ``restore(..., mesh=, placements=)``
cuts each rank's piece for the *target* mesh, so a run saved on a 2 x 2
mesh resumes on 4 x 1 or on one device.

The two packages read each other's checkpoints of the same tree.  numpy
cannot store bf16 (the JAX package holds it through ``ml_dtypes``, which
the port does not use): bf16 and fp8 leaves are stored as same-width
unsigned ints and the manifest records the true dtype; tensors cross
through that integer view, as ``weights.to_torch`` does.  Restore takes
the target ``device`` (and, sharded, a bound mesh and a
:class:`~repro_torch.dist.sharding.Placement` tree) where the JAX package
takes shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.device import DEFAULT, resolve
from repro_torch.tree import flatten_with_paths, map_structure

# numpy containers can't serialise bf16 / fp8 — store them as same-width
# unsigned ints and record the true dtype in the manifest
_ALIASED = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8, "float8_e5m2": np.uint8}
_TORCH_ALIASED = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
                  "float8_e5m2": torch.float8_e5m2}
_TORCH_NAMES = {v: k for k, v in _TORCH_ALIASED.items()}
#: the signed ints of the same widths (torch has no uint16 views to numpy)
_TORCH_INT = {2: (torch.int16, np.int16), 1: (torch.uint8, np.uint8)}


def _encode(leaf) -> tuple[np.ndarray, str]:
    """A tensor or numpy array -> (the array npz stores, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _TORCH_NAMES.get(t.dtype)
        if name is not None:
            as_int, _ = _TORCH_INT[t.element_size()]
            return t.view(as_int).numpy().view(_ALIASED[name]), name
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if name in _ALIASED:
        return arr.view(_ALIASED[name]), name
    return arr, name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _TORCH_ALIASED:
        _, np_int = _TORCH_INT[arr.dtype.itemsize]
        raw = torch.from_numpy(np.array(arr, copy=True).view(np_int))
        return raw.view(_TORCH_ALIASED[name])
    return torch.from_numpy(np.array(arr, copy=True))


def _unflatten_into(flat: dict, template, prefix=""):
    """Rebuild ``template``'s structure with the leaves of ``flat``."""
    if isinstance(template, dict):
        return {k: _unflatten_into(flat, v, f"{prefix}{k}/") for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(_unflatten_into(flat, getattr(template, k), f"{prefix}{k}/")
                                for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(flat, v, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, meta: dict | None = None, mesh=None,
             placements=None) -> str:
        """Write ``tree`` as step ``step``.  With ``mesh`` (bound) and
        ``placements`` every rank calls this with its pieces: the leaves are
        gathered to full arrays, rank 0 writes them, and the ranks meet at
        a barrier before they return."""
        if placements is not None:
            import torch.distributed as dist

            from repro_torch.dist import sharding

            tree = sharding.gather_tree(tree, placements, mesh)
            if mesh.rank != 0:
                dist.barrier()
                return os.path.join(self.dir, f"step_{step:08d}")
            try:
                return self._write(step, tree, meta)
            finally:
                dist.barrier()
        return self._write(step, tree, meta)

    def _write(self, step: int, tree, meta: dict | None) -> str:
        flat, dtypes = {}, {}
        for k, v in flatten_with_paths(tree).items():
            flat[k], dtypes[k] = _encode(v)
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": sorted(flat),
            "dtypes": dtypes,
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template, *, device: str | torch.device = DEFAULT,
                mesh=None, placements=None):
        """Restore into ``template``'s structure (its leaves only name the
        paths), each leaf a tensor on ``device`` in the dtype it was saved
        in; with ``mesh`` (bound) and ``placements``, each leaf is this
        rank's piece for that mesh.  ``KeyError`` if the checkpoint lacks a
        leaf of the template."""
        dev = resolve(device)
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        dtypes = self.manifest(step).get("dtypes", {})
        wanted = flatten_with_paths(template)
        with np.load(path) as z:
            missing = [p for p in wanted if p not in z.files]
            if missing:
                raise KeyError(f"checkpoint missing leaf {missing[0]!r}")
            flat = {p: _decode(z[p], dtypes.get(p, z[p].dtype.name)) for p in wanted}
        tree = _unflatten_into(flat, template)
        if placements is not None:
            from repro_torch.dist import sharding

            tree = sharding.shard_tree(tree, placements, mesh)
        return map_structure(lambda x: x.to(dev), tree)
