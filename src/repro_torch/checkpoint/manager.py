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

The two packages read each other's checkpoints of the same tree.  numpy
cannot store bf16 (the JAX package holds it through ``ml_dtypes``, which
the port does not use): bf16 and fp8 leaves are stored as same-width
unsigned ints and the manifest records the true dtype; tensors cross
through that integer view, as ``weights.to_torch`` does.  Restore takes
the target ``device`` where the JAX package takes shardings.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.device import DEFAULT, resolve
from repro_torch.tree import flatten_with_paths

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
    def save(self, step: int, tree, *, meta: dict | None = None) -> str:
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

    def restore(self, step: int, template, *, device: str | torch.device = DEFAULT):
        """Restore into ``template``'s structure (its leaves only name the
        paths), each leaf a tensor on ``device`` in the dtype it was saved
        in.  ``KeyError`` if the checkpoint lacks a leaf of the template."""
        dev = resolve(device)
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        dtypes = self.manifest(step).get("dtypes", {})
        wanted = flatten_with_paths(template)
        with np.load(path) as z:
            missing = [p for p in wanted if p not in z.files]
            if missing:
                raise KeyError(f"checkpoint missing leaf {missing[0]!r}")
            flat = {p: _decode(z[p], dtypes.get(p, z[p].dtype.name)).to(dev) for p in wanted}
        return _unflatten_into(flat, template)
