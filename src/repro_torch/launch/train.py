"""Training launcher of the port: data -> step -> checkpoint loop with
crash / resume, on one device.

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

Refused, each raising with the ROADMAP item it waits for: a mesh other
than 1 x 1, ``--fsdp`` and ``--compress`` (Queue 1 item 7, distribution),
``--trace`` (item 8, tooling).  Encoder-decoder archs exit, as in the
JAX launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --device cpu --steps 12 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 100 --batch 8 --seq 128 --ckpt-every 20
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

from repro_torch import kernels
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.data import pipeline
from repro_torch.device import DEFAULT, resolve
from repro_torch.dist.step import MESH_ITEM, build_train_step
from repro_torch.models import lm
from repro_torch.nn.spec import abstract_params
from repro_torch.optim import adamw

TOOLING_ITEM = "ROADMAP Queue 1 item 8 (tooling)"


def train_loop(args, *, params=None) -> dict:
    """Run the loop of ``args`` (the parsed flags); ``params`` (on the
    chosen device) replaces the seeded initial parameters.  Returns the
    losses of the steps run, the first step, each step's wall seconds
    (the batch, the step and the loss read back) and the final
    parameters."""
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "audio":
        raise SystemExit("use examples/train_lm.py-style drivers for enc-dec")
    if (args.mesh_data, args.mesh_model) != (1, 1):
        raise NotImplementedError(
            f"--mesh-data {args.mesh_data} --mesh-model {args.mesh_model}: the port trains "
            f"on one device (a 1 x 1 mesh); a device mesh is {MESH_ITEM}")
    device = resolve(args.device)

    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps)
    bundle = build_train_step(
        cfg, ShapeCfg("custom", "train", args.seq, args.batch), fsdp=args.fsdp,
        compress_pod_grads=args.compress, opt_cfg=opt_cfg,
        loss_chunk=None if args.seq <= 512 else 512)

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
            print(f"resuming from checkpoint step {latest}")
            params = ckpt.restore(latest, abstract_params(lm.model_spec(cfg)), device=device)
            start = latest
        elif params is None:
            params = lm.init(cfg, seed=args.seed, device=device)
        opt_state = adamw.init(params, opt_cfg)  # moments restart on a resume (demo scale)

        t0 = time.time()
        for step in range(start, args.steps):
            if args.simulate_failure_at is not None and step == args.simulate_failure_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            t_step = time.perf_counter()
            batch = pipeline.batch(data_cfg, step, device)
            params, opt_state, loss, metrics = bundle.fn(params, opt_state, batch, step)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t_step)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {float(loss):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0)/max(step-start+1,1):.2f}s/step)")
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, params, meta={
                    "arch": cfg.name, "mesh": {"data": 1, "model": 1}, "loss": float(loss),
                })
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "start": start, "step_seconds": step_s, "params": params}


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
                    help=f"not ported yet ({TOOLING_ITEM}): raises")
    ap.add_argument("--device", default=DEFAULT,
                    help="torch device to train on (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv: list[str] | None = None, *, params=None) -> dict:
    """Run the launcher; ``params`` (on the chosen device) replaces the
    seeded initial parameters (the tests pass JAX's, converted)."""
    args = parser().parse_args(argv)
    if args.trace:
        raise NotImplementedError(f"--trace is not ported yet: {TOOLING_ITEM}")
    out = train_loop(args, params=params)
    print(f"done; final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
