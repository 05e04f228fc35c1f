"""Start ``n`` ranks of one ``torch.distributed`` process group, each in
its own process, and collect what each returns.

* the group meets through a ``FileStore`` in a fresh temporary directory
  (no TCP port: the ranks may share a host with other groups, and need
  no network);
* ``backend="gloo"`` runs the ranks on the CPU, each pinned to one torch
  thread; ``"nccl"`` gives rank ``r`` card ``r`` (there is no fallback
  from one to the other: a group that cannot start fails the run);
* every collective of the group waits at most ``timeout`` seconds
  (``init_process_group(timeout=...)``), so a rank that fails cannot
  leave the others blocked forever;
* the parent polls the ranks and kills every rank still alive as soon
  as one fails, or when ``join_timeout`` seconds have passed.  The
  defaults, 60 s and 600 s, suit tests and checks of a few steps; a run
  of unknown length (the training launcher's) passes a collective
  timeout of its own and ``join_timeout=None``: no deadline, but still
  killed when a rank fails.

``fn`` must be importable by name (the ranks are spawned, not forked)
and its return value picklable; :func:`run` returns them by rank.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

#: the longest any collective of a spawned group waits
DEFAULT_TIMEOUT = 60.0


def _rank_main(rank: int, world: int, fn, args: tuple, store: str, backend: str,
               timeout: float, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        if backend == "gloo":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    if result[0] != "ok":
        raise SystemExit(1)  # the parent stops waiting for the other ranks


def run(fn, world: int, *args, backend: str = "gloo", timeout: float = DEFAULT_TIMEOUT,
        join_timeout: float | None = 600.0) -> list:
    """``fn(*args)`` on ``world`` ranks of one group; their results by rank.
    ``join_timeout=None`` waits for the ranks with no deadline."""
    import multiprocessing as mp

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        import torch

        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"{world} NCCL ranks need {world} cards; {have} visible")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, fn, args, os.path.join(d, "store"), backend,
                                   timeout, d))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        try:
            # poll every rank: the first to fail ends the wait for the rest
            while ((deadline is None or time.monotonic() < deadline)
                   and any(p.is_alive() for p in procs)):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.02)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join(10.0)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code {p.exitcode}"
                              f"{', killed' if p in alive else ''})")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r}:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n" + "\n".join(errors))
        return results


__all__ = ["DEFAULT_TIMEOUT", "run"]
