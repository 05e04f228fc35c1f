"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on
``meta`` tensors — the port's counterpart of the JAX package's
``launch/dryrun.py``, which lowers and compiles each cell on 512 fake
devices.

For each cell the dry run:

1. builds the production mesh ((16, 16) single-pod / (2, 16, 16)
   multi-pod) as a :class:`~repro_torch.launch.mesh.Mesh` with no
   devices, and rank 0's seat on it (``mesh.seat``: no process group);
2. builds the step bundle (train / prefill / decode per the shape) over
   that seat, and makes rank 0's pieces of every input as ``meta``
   tensors (``bundle.local_inputs()``);
3. runs the step once under the ``reference`` backend and the recorders
   of :mod:`repro_torch.launch.hlo` — nothing is allocated, compiled or
   launched — which proves the sharding coherent (every piece's shape
   meets the model-axis compute, every collective has its shapes);
4. records the per-device memory, cost and collective figures, under
   JAX's record keys (``trace_s`` in place of ``lower_s`` / ``compile_s``).

On the CPU the dry run names no device but ``meta``.  It is not a path a
kernel's absence could hide behind: it computes no values, so it holds
no kernel to its plain version and claims nothing of one.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl

It exits 1 if any cell errs, as JAX's does.  Beyond JAX's flags,
``--jobs N`` traces the cells in N processes (each cell is independent
and single-threaded; the records keep their order).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import time
import traceback

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.dist.step import build_step
from repro_torch.launch import hlo
from repro_torch.launch.mesh import make_production_mesh, seat


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, fsdp: bool = False,
             compress: bool = False, loss_chunk: int = 512, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    label = "multi" if multi_pod else "single"
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": label, "status": "skipped",
                "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    kw = {}
    if SHAPES[shape_name].kind == "train":
        kw = dict(fsdp=fsdp, compress_pod_grads=compress, loss_chunk=loss_chunk)
    elif fsdp:
        kw = dict(fsdp=fsdp)
    bundle = build_step(cfg, shape_name, mesh=seat(mesh), **kw)
    rec = hlo.record_step(bundle.fn, bundle.local_inputs())
    mem, cost = hlo.memory_summary(rec), hlo.cost_summary(rec)
    an = hlo.analyze_step(rec, n_devices=mesh.size)
    out = {
        "arch": arch,
        "shape": shape_name,
        "mesh": label,
        "mesh_shape": dict(mesh.shape),
        "status": "ok",
        "trace_s": round(rec.trace_s, 2),
        "fsdp": fsdp,
        "compress": compress,
        "memory": mem,
        "cost": cost,
        "hlo": {k: an[k] for k in ("dot_flops", "collective_bytes", "collective_counts",
                                   "collective_bytes_by_op", "result_bytes")},
    }
    if verbose:
        print(f"[{bundle.name} @ {label}] trace {rec.trace_s:.1f}s  "
              f"argMB/dev {mem['argument_mb_per_device']:.0f}  "
              f"tempMB/dev {mem['temp_mb_per_device']:.0f}  "
              f"dotTFLOP/dev {an['dot_flops'] / 1e12:.2f}  "
              f"collMB/dev {an['collective_bytes'] / 1e6:.1f}", flush=True)
    return out


def _cell_record(arch: str, shape: str, multi_pod: bool, fsdp: bool, compress: bool,
                 loss_chunk: int) -> dict:
    """:func:`run_cell`, with a failing cell's error as its record."""
    try:
        return run_cell(arch, shape, multi_pod=multi_pod, fsdp=fsdp, compress=compress,
                        loss_chunk=loss_chunk)
    except Exception as e:  # a failing cell is a bug: surface it
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": "multi" if multi_pod else "single",
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def cells(all_cells: bool, arch: str | None, shape: str | None) -> list[tuple[str, str]]:
    if not all_cells:
        if not (arch and shape):
            raise SystemExit("--arch/--shape or --all required")
        return [(arch, shape)]
    return [(a, s) for a in ARCHS for s in SHAPES if applicable(get_config(a), s)[0]]


def main(argv=None) -> list[dict]:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every applicable cell")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--out", default=None, help="append JSON records to this file")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many processes (records keep their order)")
    args = ap.parse_args(argv)

    print(f"torch {torch.__version__}: tracing on meta tensors", flush=True)
    t0 = time.perf_counter()
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = [(arch, shape, mp, args.fsdp, args.compress, args.loss_chunk)
            for arch, shape in cells(args.all, args.arch, args.shape) for mp in meshes]
    records = []
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:  # the cells are independent: spread them over processes
            pool = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")))
            results = pool.map(_cell_record, *zip(*todo))
        else:
            results = (_cell_record(*cell) for cell in todo)
        for rec in results:
            records.append(rec)
            if args.out:  # append as we go (long runs survive kills)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    print(f"dry-run seconds: {time.perf_counter() - t0:.1f}", flush=True)
    if n_err:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
