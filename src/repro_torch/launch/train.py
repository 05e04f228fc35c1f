"""Training launcher of the port: data -> step -> checkpoint loop with
crash / resume, on one device or a mesh of ranks.

``python -m repro_torch.launch.train`` takes the JAX launcher's flags
(``--arch --reduced --steps --batch --seq --lr --seed --ckpt-dir
--ckpt-every --resume --log-every --simulate-failure-at
--kernel-policy``) plus ``--device`` (default ``cuda``) and prints the
same lines: ``step …`` every ``--log-every`` steps, ``resuming from
checkpoint step N`` and ``done; final loss …``.  As in the JAX launcher:

* the data are the seeded synthetic tokens of ``data/pipeline.py``, so
  any step's batch can be rebuilt after a restart;
* every ``--ckpt-every`` steps the parameters are saved (keep the last
  2); ``--simulate-failure-at N`` raises ``RuntimeError`` at step N, and
  ``--resume`` restores the latest checkpoint's parameters and restarts
  the moments from zero;
* AdamW with warmup ``max(steps // 20, 5)`` and cosine decay over
  ``--steps``; the loss is chunked above 512 positions;
* ``--kernel-policy`` forces the matmul schedule (``tiled`` K1, ``mcast``
  K4, ``unicast`` K5; ``reference`` the plain oracle); the default is
  the cost model's pick.

``--trace PATH`` arms a recorder (:mod:`repro_torch.obs.trace`) for the
run and writes its Chrome/Perfetto trace at ``PATH`` (``.jsonl``: one
event per line) when the loop ends or raises: one ``dispatch.<op>`` span
per kernel call (the port dispatches eagerly, where the JAX launcher's
trace holds one per compiled program), then ``wrote trace …``.  On a
mesh rank 0 records and writes the one file, as the serving launcher's
``--mesh --trace`` does.

``--mesh-data D --mesh-model M`` trains on a D x M mesh
(``launch/mesh.py``), one rank per mesh position, through the mesh step
of ``dist/step.py`` (parameters placed by ``dist/sharding.py``,
``--fsdp`` adding the data axis; the batch rows split over the batch
axes; with ``M`` > 1 each rank computes over the model axis, on its
heads, feed-forward columns, experts, vocabulary rows and RG-LRU
channels: ``dist/tp.py``).  With no process group in the environment (none initialised,
no ``WORLD_SIZE`` from ``torchrun``) the launcher starts the D x M ranks
itself (``dist/spawn.py``): gloo ranks on ``--device cpu``, one NCCL
rank per card on ``cuda`` — a mesh larger than the visible cards raises,
naming the count; there is no fallback from NCCL to gloo.  The ranks run
as long as the training does (no join deadline; all are killed as soon
as one fails), and a collective of their group waits at most
:func:`collective_timeout`: torch's default plus the time rank 0 may
take to write a checkpoint while the others wait for it.  Rank 0 prints
the lines and writes the checkpoints (every leaf gathered to its full
array, ``"mesh": {"data": D, "model": M}`` in the manifest's meta), and
``--resume`` restores each rank's pieces for the mesh it runs on, which
may differ from the mesh that saved (elastic restore).  ``--compress``
runs the gradients through int8 block compression with error feedback
(``dist/compression.py``); ``--fsdp`` and ``--compress`` work on one
device too.  Encoder-decoder archs exit, as in the JAX launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --device cpu --steps 12 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --device cpu --steps 12 --batch 4 --seq 32 \\
        --mesh-data 2 --mesh-model 2 --fsdp --compress
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 100 --batch 8 --seq 128 --ckpt-every 20 [--trace /tmp/train.json]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import torch

from repro_torch import kernels, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.data import pipeline
from repro_torch.device import DEFAULT, resolve
from repro_torch.dist import sharding, spawn
from repro_torch.dist.compression import init_error_state
from repro_torch.dist.step import build_train_step
from repro_torch.launch.mesh import bind, make_debug_mesh
from repro_torch.models import lm
from repro_torch.nn.spec import abstract_params
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw


#: the rate, in bytes a second, at which :func:`collective_timeout` lets
#: rank 0 gather and write a checkpoint while the other ranks wait
CKPT_WRITE_RATE = 50e6


def collective_timeout(cfg) -> float:
    """Seconds any collective of a mesh run's group may wait: torch's
    default process-group timeout, plus ``cfg``'s parameter bytes at
    :data:`CKPT_WRITE_RATE` (a save gathers every leaf to rank 0, which
    writes them while the other ranks wait at a barrier)."""
    import torch.distributed as dist

    nbytes = sum(x.numel() * x.element_size()
                 for x in tree.leaves(abstract_params(lm.model_spec(cfg))))
    return dist.default_pg_timeout.total_seconds() + nbytes / CKPT_WRITE_RATE


def _in_process_group() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1


def _join_process_group(device, timeout: float) -> None:
    """Join the group ``torchrun``'s environment describes (NCCL on the
    card, gloo on the CPU), where none is initialised yet."""
    import datetime

    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=timeout))


def train_loop(args, *, params=None) -> dict:
    """Run the loop of ``args`` (the parsed flags) on this process: one
    device, or this rank's place in the mesh when a process group is up.
    ``params`` (full, on the chosen device) replaces the seeded initial
    parameters.  Returns the losses of the steps run, the first step,
    each step's wall seconds (the batch, the step and the loss read back)
    and the final parameters (this rank's pieces on a mesh)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "audio":
        raise SystemExit("use examples/train_lm.py-style drivers for enc-dec")
    mesh_cfg = make_debug_mesh(data=args.mesh_data, model=args.mesh_model)
    device = resolve(args.device)
    mesh = None
    if _in_process_group():
        _join_process_group(device, collective_timeout(cfg))
        mesh = bind(mesh_cfg)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    elif mesh_cfg.size > 1:
        raise RuntimeError(f"a {mesh_cfg.shape} mesh needs a process group: run it "
                           f"through main(), which starts the ranks")
    log = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)

    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps)
    bundle = build_train_step(
        cfg, ShapeCfg("custom", "train", args.seq, args.batch), mesh=mesh, fsdp=args.fsdp,
        compress_pod_grads=args.compress, opt_cfg=opt_cfg,
        loss_chunk=None if args.seq <= 512 else 512)
    placements = bundle.placements

    data_cfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                   global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    policy = (kernels.use_policy(args.kernel_policy) if args.kernel_policy
              else contextlib.nullcontext())
    start = 0
    losses, step_s = [], []
    with policy:
        latest = ckpt.latest_step()
        if latest is not None and args.resume:
            log(f"resuming from checkpoint step {latest}")
            params = ckpt.restore(latest, abstract_params(lm.model_spec(cfg)), device=device,
                                  mesh=mesh, placements=placements)
            start = latest
        else:
            if params is None:
                params = lm.init(cfg, seed=args.seed, device=device)
            if placements is not None:
                params = sharding.shard_tree(params, placements, mesh)
        opt_state = adamw.init(params, opt_cfg)  # moments restart on a resume (demo scale)
        err_state = init_error_state(params) if args.compress else None

        t0 = time.time()
        for step in range(start, args.steps):
            if args.simulate_failure_at is not None and step == args.simulate_failure_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            t_step = time.perf_counter()
            rec = obs_trace.active()
            t_rec = rec.now() if rec is not None else 0.0
            if mesh is None:
                batch = pipeline.batch(data_cfg, step, device)
            else:
                batch = pipeline.sharded_batch(data_cfg, step, mesh, bundle.batch_axes, device)
            if args.compress:
                params, opt_state, err_state, loss, metrics = bundle.fn(
                    params, opt_state, err_state, batch, step)
            else:
                params, opt_state, loss, metrics = bundle.fn(params, opt_state, batch, step)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t_step)
            if rec is not None:
                rec.complete("train.step", t_rec, cat="train",
                             args={"step": step, "rank": 0 if mesh is None else mesh.rank})
            if step % args.log_every == 0:
                log(f"step {step:5d} loss {float(loss):.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"({(time.time()-t0)/max(step-start+1,1):.2f}s/step)")
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, params, meta={
                    "arch": cfg.name, "mesh": mesh_cfg.shape, "loss": float(loss),
                }, mesh=mesh, placements=placements)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "start": start, "step_seconds": step_s, "params": params}


def _rank_main(argv: list[str], params=None) -> dict | None:
    """One spawned rank of :func:`main`: the loop of ``argv`` from
    ``params`` (full, on the CPU; None: the seeded init); rank 0 returns its
    result without the parameters."""
    import torch.distributed as dist

    args = parser().parse_args(argv)
    if params is not None:
        device = resolve(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        params = tree.map_structure(lambda t: t.to(device), params)
    out = _traced_loop(args, params)
    if dist.get_rank() != 0:
        return None
    return {k: v for k, v in out.items() if k != "params"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--kernel-policy", default=None,
                    help='kernel dispatch policy, e.g. "tiled", "mcast", "unicast" or '
                         '"reference" (see repro_torch.kernels.api)')
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto/Chrome trace-event JSON of the run here "
                         "(one dispatch span per kernel call)")
    ap.add_argument("--device", default=DEFAULT,
                    help="torch device to train on (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv: list[str] | None = None, *, params=None, timeout: float | None = None,
         join_timeout: float | None = None) -> dict:
    """Run the launcher; ``params`` (on the chosen device; on the CPU for a
    mesh, whose ranks each take a copy) replaces the seeded initial
    parameters (the tests pass JAX's, converted).  A mesh above one rank,
    with no process group in the environment, runs on ranks this call
    starts: rank 0's result comes back without its parameters.  ``timeout`` and ``join_timeout`` bound those ranks as
    ``spawn.run``'s do; by default :func:`collective_timeout` and no join
    deadline (tests pass short ones)."""
    args = parser().parse_args(argv)
    world = args.mesh_data * args.mesh_model
    if world > 1 and not _in_process_group():
        from repro_torch.launch.train import _rank_main  # by name, also under -m

        backend = "nccl" if resolve(args.device).type == "cuda" else "gloo"
        if timeout is None:
            timeout = collective_timeout(get_config(args.arch, reduced=args.reduced))
        rank_args = (list(argv if argv is not None else sys.argv[1:]),) \
            + (() if params is None else (params,))
        out = spawn.run(_rank_main, world, *rank_args, backend=backend, timeout=timeout,
                        join_timeout=join_timeout)[0]
        print(f"done; final loss {out['final_loss']:.4f}")
        return out
    out = _traced_loop(args, params)
    print(f"done; final loss {out['final_loss']:.4f}")
    return out


def _traced_loop(args, params) -> dict:
    """:func:`train_loop`, recorded to ``--trace`` where given: on one
    device, or on rank 0 of a mesh (the other ranks record nothing)."""
    if not args.trace or (_in_process_group() and _rank() != 0):
        return train_loop(args, params=params)
    from repro_torch.obs import export as obs_export

    rec = obs_trace.start(meta={"tool": "launch.train", "seed": args.seed,
                                "mesh": {"data": args.mesh_data, "model": args.mesh_model}})
    try:
        return train_loop(args, params=params)
    finally:
        obs_trace.stop()
        obs_export.write(rec, args.trace)
        print(f"wrote trace {args.trace} ({len(rec)} events)")


def _rank() -> int:
    """This process's rank in the group it is in or will join."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))


if __name__ == "__main__":
    main()
