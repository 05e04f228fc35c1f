"""The rank functions of the port's multi-rank tests
(``tests/test_torch_dist.py``, ``tests/test_torch_mesh_serve.py``,
``tests/test_torch_mesh_opts.py``), started by ``repro_torch.dist.spawn.run``
on gloo ranks: importable by name, no JAX, results as plain Python and
numpy values (each rank's, the test reads them by rank).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCfg
from repro_torch.data import pipeline
from repro_torch.dist import compression, mcast, sharding
from repro_torch.dist.step import build_train_step
from repro_torch.launch.mesh import bind, make_debug_mesh
from repro_torch.models import lm
from repro_torch.nn.spec import abstract_params
from repro_torch.optim import adamw

ARCH = "qwen1.5-0.5b"
#: the train step's shape and schedule, shared with the one-device runs
TRAIN = dict(batch=8, seq=32, steps=4, lr=3e-3, seed=0)
#: the (fsdp, compress) runs of every mesh
TRAIN_RUNS = ((False, False), (True, False), (True, True))
#: the MoE train runs: the reduced moonshot, its batch split over ranks
MOE_TRAIN = dict(arch="moonshot-v1-16b-a3b", batch=8, seq=16, steps=4, lr=3e-3, seed=0)


def payload(seed: int, shape=(6, 10)) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def collectives(data: int) -> dict:
    """Every mode on a ``data`` x 1 mesh: what the broadcast delivers (the
    source's payload; every other rank offers garbage) and its rounds, the
    row-shard weight gather against ``all_gather`` and the full weight,
    and ``mcast_matmul`` against ``x @ w``."""
    import torch.distributed as dist

    mesh = bind(make_debug_mesh(data, 1))
    r = mesh.rank
    out = {"coords": mesh.coords}
    for mode in mcast.MODES:  # from every source index: the same rounds
        bcast = mcast.make_broadcast_fn(mesh, (6, 10), torch.float32, mode)
        for s in range(data):
            got = bcast(payload(50 + s) if r == s else payload(200 + r), source=s)
            out[f"{mode}/from{s}"] = (bool(torch.equal(got, payload(50 + s))), bcast.rounds)
    src = payload(0)
    mine = src if r == 0 else payload(100 + r)
    full = payload(1, (4 * data, 5))
    local = full[4 * r:4 * (r + 1)].clone()
    x = payload(2, (2 * data, 6))
    w = payload(3, (6, 5)) if r == 0 else torch.zeros(6, 5)
    for mode in mcast.MODES:
        bcast = mcast.make_broadcast_fn(mesh, src.shape, src.dtype, mode)
        out[f"{mode}/bcast_exact"] = bool(torch.equal(bcast(mine), src))
        out[f"{mode}/bcast_rounds"] = bcast.rounds
        gather = mcast.make_weight_gather_fn(mesh, full.shape, full.dtype, mode)
        g = gather(local)
        ref = [torch.empty_like(local) for _ in range(data)]
        dist.all_gather(ref, local)
        out[f"{mode}/gather_exact"] = bool(torch.equal(g, torch.cat(ref))) \
            and bool(torch.equal(g, full))
        out[f"{mode}/gather_rounds"] = gather.rounds
        xs = x[2 * r:2 * (r + 1)]
        out[f"{mode}/matmul_exact"] = bool(torch.equal(mcast.mcast_matmul(xs, w, mesh, mode=mode),
                                                       xs @ payload(3, (6, 5))))
    return out


#: the data of the ``sharded_batch`` cases
BATCH_DATA = pipeline.DataConfig(vocab=512, seq_len=16, global_batch=8, seed=5)


def batches(mesh_shape: tuple[int, int]) -> dict:
    """This rank's ``sharded_batch`` rows (step 3) on a ``mesh_shape`` mesh,
    for the batch split over the data axis, over both axes and over none:
    its ``shard_rows`` block and the tokens and labels."""
    mesh = bind(make_debug_mesh(*mesh_shape))
    out = {"coords": mesh.coords}
    for ba in (("data",), ("data", "model"), ()):
        b = pipeline.sharded_batch(BATCH_DATA, 3, mesh, ba, "cpu")
        out[ba] = (pipeline.shard_rows(8, mesh, ba), b["tokens"].numpy(), b["labels"].numpy())
    return out


def four_ranks() -> dict:
    """The 4-rank cases: the collectives on 4 x 1, the batches on 4 x 1 and
    2 x 2, and where ``DeviceMesh`` puts this rank on a 2 x 2 mesh."""
    return {"collectives": collectives(4), "batches 4x1": batches((4, 1)),
            "batches 2x2": batches((2, 2)),
            "device_mesh 2x2": tuple(bind(make_debug_mesh(2, 2)).device_mesh.get_coordinate())}


def one_rank(params: dict, moe_params: dict) -> dict:
    """The 1 x 1 runs, dense and MoE."""
    return {"train": train_on((1, 1), params), "moe": moe_on((1, 1), moe_params)}


def two_ranks(params: dict, moe_params: dict) -> dict:
    """The 2-rank cases: the 2 x 1 train runs, dense and MoE."""
    return {"train": train_on((2, 1), params), "moe": moe_on((2, 1), moe_params)}


def global_rows(data: pipeline.DataConfig, step: int, mesh, batch_axes) -> dict:
    """This rank's rows of ``global_batch_np`` (its ``shard_rows`` block),
    as ``tests/_multidev_main.py`` feeds JAX's mesh step the one-device
    batch: a mesh step held to the one-device step must see its rows."""
    start, n = pipeline.shard_rows(data.global_batch, mesh, batch_axes)
    return {k: torch.from_numpy(np.ascontiguousarray(v[start:start + n]))
            for k, v in pipeline.global_batch_np(data, step).items()}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def train_on(mesh_shape: tuple[int, int], params: dict, ckpt_dir: str | None = None,
             restore_from: tuple[str, int] | None = None) -> dict:
    """The reduced qwen's train step on a ``mesh_shape`` mesh, ``TRAIN``'s
    steps from ``params`` (full), per ``TRAIN_RUNS`` case: the losses and,
    on rank 0, the final parameters gathered.  ``ckpt_dir``: the fsdp run
    saves its final parameters there (step ``TRAIN["steps"]``) and, on a
    second mesh of the same ranks, ``restore_from`` = (dir, step) is
    restored onto this mesh (fsdp placements) and gathered back."""
    cfg = get_config(ARCH, reduced=True)
    mesh = bind(make_debug_mesh(*mesh_shape))
    out = {}
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=5, total_steps=TRAIN["steps"])
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                               global_batch=TRAIN["batch"], seed=TRAIN["seed"])
    shape = ShapeCfg("custom", "train", TRAIN["seq"], TRAIN["batch"])
    for fsdp, compress in TRAIN_RUNS:
        name = f"fsdp={fsdp},compress={compress}"
        b = build_train_step(cfg, shape, mesh=mesh, fsdp=fsdp, compress_pod_grads=compress,
                             opt_cfg=opt_cfg, loss_chunk=None)
        p = sharding.shard_tree(tree.map_structure(torch.clone, params), b.placements, mesh)
        opt = adamw.init(p, opt_cfg)
        err = compression.init_error_state(p) if compress else None
        losses, norms = [], []
        for step in range(TRAIN["steps"]):
            batch = global_rows(data, step, mesh, b.batch_axes)
            if compress:
                p, opt, err, loss, metrics = b.fn(p, opt, err, batch, step)
            else:
                p, opt, loss, metrics = b.fn(p, opt, batch, step)
            losses.append(float(loss))
            norms.append(float(metrics["grad_norm"]))
        out[f"{name}/losses"] = losses
        out[f"{name}/grad_norms"] = norms
        out[f"{name}/batch_axes"] = b.batch_axes
        out[f"{name}/cut_leaves"] = {  # leaves cut over each axis of more than one rank
            a: sum(a in pl.spec for pl in tree.leaves(b.placements))
            for a in mesh.axis_names if mesh.shape[a] > 1}
        full = sharding.gather_tree(p, b.placements, mesh)
        if mesh.rank == 0:
            out[f"{name}/params"] = {k: _np(v) for k, v in
                                     tree.flatten_with_paths(full).items()}
        if ckpt_dir is not None and fsdp and not compress:
            CheckpointManager(ckpt_dir).save(TRAIN["steps"], p, mesh=mesh,
                                             placements=b.placements,
                                             meta={"mesh": mesh.shape})
            out["saved_full"] = {k: _np(v) for k, v in tree.flatten_with_paths(full).items()} \
                if mesh.rank == 0 else None
    if restore_from is not None:
        placements = sharding.param_shardings(cfg, lm.model_spec(cfg), mesh, fsdp=True)
        ckpt_dir, step = restore_from
        template = abstract_params(lm.model_spec(cfg))
        pieces = CheckpointManager(ckpt_dir).restore(step, template, device="cpu",
                                                     mesh=mesh, placements=placements)
        out["restored_shapes"] = {k: tuple(v.shape) for k, v in
                                  tree.flatten_with_paths(pieces).items()}
        full = sharding.gather_tree(pieces, placements, mesh)
        if mesh.rank == 0:
            out["restored_full"] = {k: v.clone() for k, v in
                                    tree.flatten_with_paths(full).items()}
    return out


def train_alone(params: dict, compress: bool, flip: bool = False) -> dict:
    """The same steps on one device (``mesh=None``); ``flip``: the witness,
    with the last bit of every layer-0 input element flipped (one bf16
    ulp), as ``tests/_torch_jax_ref.py``'s train witness flips JAX's."""
    from unittest import mock

    cfg = get_config(ARCH, reduced=True)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=5, total_steps=TRAIN["steps"])
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                               global_batch=TRAIN["batch"], seed=TRAIN["seed"])
    b = build_train_step(cfg, ShapeCfg("custom", "train", TRAIN["seq"], TRAIN["batch"]),
                         compress_pod_grads=compress, opt_cfg=opt_cfg, loss_chunk=None)
    real = lm._embed_inputs

    def flipped(*a, **k):
        return (real(*a, **k).view(torch.int16) ^ 1).view(torch.bfloat16)

    p = tree.map_structure(torch.clone, params)
    opt = adamw.init(p, opt_cfg)
    err = compression.init_error_state(p) if compress else None
    losses = []
    with mock.patch.object(lm, "_embed_inputs", flipped) if flip else _nothing():
        for step in range(TRAIN["steps"]):
            batch = pipeline.batch(data, step, "cpu")
            if compress:
                p, opt, err, loss, _ = b.fn(p, opt, err, batch, step)
            else:
                p, opt, loss, _ = b.fn(p, opt, batch, step)
            losses.append(float(loss))
    return {"losses": losses, "params": {k: _np(v) for k, v in
                                         tree.flatten_with_paths(p).items()}}


def _nothing():
    import contextlib

    return contextlib.nullcontext()


def train_then_restore(params: dict, ckpt_dir: str, moe_params: dict) -> list[dict]:
    """On 4 ranks: the 2 x 2 runs (saving the fsdp one), then the 4 x 1
    runs on the same ranks, restoring the 2 x 2 checkpoint onto 4 x 1;
    then the MoE runs on 2 x 2 and 4 x 1."""
    first = train_on((2, 2), params, ckpt_dir=ckpt_dir)
    second = train_on((4, 1), params, restore_from=(ckpt_dir, TRAIN["steps"]))
    return [first, second, {"2x2": moe_on((2, 2), moe_params),
                            "4x1": moe_on((4, 1), moe_params)}]


def _moe_setup():
    cfg = get_config(MOE_TRAIN["arch"], reduced=True)
    opt_cfg = adamw.AdamWConfig(lr=MOE_TRAIN["lr"], warmup_steps=5,
                                total_steps=MOE_TRAIN["steps"])
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=MOE_TRAIN["seq"],
                               global_batch=MOE_TRAIN["batch"], seed=MOE_TRAIN["seed"])
    return cfg, opt_cfg, data, ShapeCfg("custom", "train", MOE_TRAIN["seq"], MOE_TRAIN["batch"])


def moe_on(mesh_shape: tuple[int, int], params: dict) -> dict:
    """The reduced moonshot's train step on a ``mesh_shape`` mesh, each
    rank fed its rows of ``global_batch_np``: the losses of
    ``MOE_TRAIN``'s steps, step 0's aux loss (this rank's, the routing
    fractions averaged over the batch ranks, then averaged over them as the
    step averages the loss), the batch axes and the ``ce`` all-reduces."""
    import torch.distributed as dist

    cfg, opt_cfg, data, shape = _moe_setup()
    mesh = bind(make_debug_mesh(*mesh_shape))
    b = build_train_step(cfg, shape, mesh=mesh, opt_cfg=opt_cfg, loss_chunk=None)
    p = sharding.shard_tree(tree.map_structure(torch.clone, params), b.placements, mesh)
    batch = global_rows(data, 0, mesh, b.batch_axes)
    with torch.no_grad():
        full = sharding.gather_tree(p, b.placements, mesh)
        aux = lm.forward(full, cfg, batch["tokens"], ce_reduce=b.ce_reduce)[1].clone()
    n = mesh.size(b.batch_axes)
    dist.all_reduce(aux, group=mesh.group(b.batch_axes))
    calls = b.ce_reduce.calls
    opt = adamw.init(p, opt_cfg)
    losses = []
    for step in range(MOE_TRAIN["steps"]):
        p, opt, loss, _ = b.fn(p, opt, global_rows(data, step, mesh, b.batch_axes), step)
        losses.append(float(loss))
    return {"losses": losses, "aux0": float(aux / n), "batch_axes": b.batch_axes,
            "ce_reduce_calls": calls, "n_batch": n}


def moe_alone(params: dict, flip: bool = False) -> dict:
    """The same MoE steps on one device (``mesh=None``); ``flip``: the
    flipped-ulp witness, as :func:`train_alone`'s.  Step 0's aux loss too."""
    from unittest import mock

    cfg, opt_cfg, data, shape = _moe_setup()
    b = build_train_step(cfg, shape, opt_cfg=opt_cfg, loss_chunk=None)
    real = lm._embed_inputs

    def flipped(*a, **k):
        return (real(*a, **k).view(torch.int16) ^ 1).view(torch.bfloat16)

    p = tree.map_structure(torch.clone, params)
    with torch.no_grad():
        aux = float(lm.forward(p, cfg, pipeline.batch(data, 0, "cpu")["tokens"])[1])
    opt = adamw.init(p, opt_cfg)
    losses = []
    with mock.patch.object(lm, "_embed_inputs", flipped) if flip else _nothing():
        for step in range(MOE_TRAIN["steps"]):
            p, opt, loss, _ = b.fn(p, opt, pipeline.batch(data, step, "cpu"), step)
            losses.append(float(loss))
    return {"losses": losses, "aux0": aux}


def port_serve_api(cfg, params, mesh=None, built: list | None = None, drafts=None):
    """The port's serving names as ``_torch_dist_ref``'s cases take them,
    engines on the CPU over ``mesh``; ``built`` collects every engine;
    ``drafts``: each model draft's ``(cfg, params)`` by arch, passed where
    a config names it."""
    from types import SimpleNamespace

    from repro_torch.serve import Fault, FaultPlan, PagedEngine, Request, ServeConfig

    def make(config=None, **kw):
        use = (drafts or {}).get(config.draft_model) if config is not None else None
        eng = PagedEngine(cfg, params, device="cpu", mesh=mesh, config=config, draft=use, **kw)
        if built is not None:
            built.append(eng)
        return eng

    return SimpleNamespace(PagedEngine=make, Request=Request, ServeConfig=ServeConfig,
                           Fault=Fault, FaultPlan=FaultPlan)


def home_pages(eng) -> dict[int, np.ndarray]:
    """Every page an engine's rank holds as its own (not its null page, not
    a mirror), by global id: its bytes in every pool tensor."""
    lo = 1 + eng.rank * (eng.num_device_pages - 1)
    return {pid: eng._pack([eng._home_id(pid)]).numpy()
            for pid in range(lo, lo + eng.num_device_pages - 1)}


def _refusals(cfg, params, mesh) -> dict[str, str]:
    """What the engine refuses over ``mesh`` (2 ranks): each message."""
    from repro_torch.serve import PagedEngine, ServeConfig

    base = dict(max_slots=2, cache_len=64, page_size=8, num_shards=2, pages_per_shard=8)
    out = {}

    def catch(name, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"

    catch("shards", lambda: PagedEngine(cfg, params, device="cpu", mesh=mesh,
                                        config=ServeConfig(**{**base, "num_shards": 3})))
    return out


def serve_mesh(n: int, params: dict) -> dict:
    """``_torch_dist_ref.mesh_cases`` on the port's engine over ``n`` gloo
    ranks (the reduced qwen, ``params`` JAX's converted), each engine's
    home pages at its end, and (on 2 ranks) the refusals."""
    from _torch_dist_ref import mesh_cases
    from repro_torch.launch.mesh import make_serve_mesh

    cfg = get_config(ARCH, reduced=True)
    mesh = bind(make_serve_mesh(n))
    built = []
    out = {"cases": mesh_cases(port_serve_api(cfg, params, mesh, built), n)}
    out["pages"] = [home_pages(e) for e in built]
    out["pool_bytes"] = [sum(t.numel() * t.element_size() for c in e.caches for t in c)
                         for e in built]
    if n == 2:
        out["refusals"] = _refusals(cfg, params, mesh)
    out["loop"] = loop_cases(cfg, params, mesh, n)
    return out


# -- the ServeLoop over a mesh ---------------------------------------------------

#: the pressured pool of the loop's preemption case (``reroute_case``'s)
LOOP_PRESSED = dict(max_slots=3, cache_len=64, page_size=8, num_shards=2, pages_per_shard=4,
                    watermark=0)
#: the loop's engines over 2 ranks: ``MESH``'s 4 shards, 2 a rank
LOOP_TWO = dict(max_slots=2, cache_len=64, page_size=8, num_shards=4, pages_per_shard=8)
#: the fault plan of the loop's guarded case (the one-device loop test's)
LOOP_PLAN = (("kernel.raise", dict(at=3)), ("kernel.nan", dict(at=6)), ("pool.alloc", dict(at=1)))
#: the collective timeout of the real-time case's own 2-rank world, and the
#: gap between its two halves of arrivals: a few seconds longer
REALTIME_TIMEOUT = 5.0
REALTIME_GAP = REALTIME_TIMEOUT + 3.0


def _plan(plan):
    from repro_torch.serve import Fault, FaultPlan

    return FaultPlan([Fault(site, **kw) for site, kw in plan or ()], seed=0)


def _loop_trace(cfg, gap: float = 0.0):
    """``LOOP_MESH_TRACE``'s arrivals; with ``gap``, the second half of them
    ``gap`` seconds later."""
    import dataclasses

    from _torch_dist_ref import LOOP_MESH_TRACE
    from repro_torch.serve import LoadGen

    trace = LoadGen(vocab=cfg.vocab, **LOOP_MESH_TRACE).trace()
    half = len(trace) // 2
    return [dataclasses.replace(a, t=a.t + gap) if i >= half else a for i, a in enumerate(trace)]


def _pressed_trace():
    """``reroute_case``'s three requests as arrivals at t = 0: request 0's
    page fault preempts request 2, which swaps back in on the other
    shard's rank."""
    from repro_torch.serve import Arrival

    return [Arrival(rid=i, t=0.0, prompt=tuple(range(100 + 9 * i, 109 + 9 * i)), max_new=m,
                    shared=False) for i, m in enumerate((12, 4, 12))]


def loop_run(cfg, params, mesh, conf: dict, trace, *, plan=None, realtime=False,
             abort=False, submits=None, queue_cap=None, broken=False) -> dict:
    """One ``ServeLoop`` over ``PagedEngine(mesh=)`` on this rank: rank 0
    runs the loop (``run_trace`` of ``trace``, or with ``abort`` a
    ``close(drain=False)`` once a request decodes, or ``submits`` — (prompt,
    max_new) pairs — submitted alone), every other rank follows it.  With
    ``broken`` every model step raises on rank 1 (no fallback: a step that
    fails and is not retried).  What the rank saw: its requests' tokens, the
    flat stats, the driver's log, the plan's fired log, its home pages (or
    the error it ended with); rank 0 also the states, the snapshot's
    ``loop_keys`` and, but for ``broken``, the log replayed on a one-device
    engine of ``conf`` under the same plan."""
    import time

    from _torch_dist_ref import loop_keys
    from repro_torch.serve import (
        Lifecycle,
        PagedEngine,
        ServeConfig,
        ServeLoop,
        follow,
        replay,
        validate_snapshot,
    )

    eng = PagedEngine(cfg, params, device="cpu", mesh=mesh, config=ServeConfig(**conf))
    if broken and mesh.rank == 1:
        def fail(*args):
            raise ValueError("planted failure on rank 1")

        eng._steps = {name: fail for name in eng._steps}
    swaps = []  # (rid, rank it swapped out from, rank it swapped in on)
    preempt, swap_in = eng._preempt, eng._swap_in

    def preempted(slot):
        swaps.append([eng.slots[slot].req.rid, eng._rank_of_shard(eng.slots[slot].shard)])
        preempt(slot)

    def swapped_in(slot, req):
        res = swap_in(slot, req)
        if res is True:
            for s in swaps:
                if s[0] == req.rid and len(s) == 2:
                    s.append(eng._rank_of_shard(eng.slots[slot].shard))
        return res

    eng._preempt, eng._swap_in = preempted, swapped_in
    out = {"error": None}
    fp = _plan(plan)
    t0 = time.monotonic()
    try:
        with fp:
            if mesh.rank != 0:
                driver = follow(eng)
                out["out"] = {rid: list(r.out) for rid, r in driver.requests.items()}
            else:
                loop = ServeLoop(eng, queue_cap=queue_cap)
                driver = loop.driver
                if submits is not None:
                    handles = [loop.submit(p, m) for p, m in submits]
                    loop.close()
                    results = {h.rid: h for h in handles}
                elif abort:
                    loop.warmup_for_trace(trace)
                    for a in trace:
                        loop.submit(a.prompt, a.max_new, rid=a.rid)
                    deadline = time.monotonic() + 60
                    while not any(r.state is Lifecycle.DECODING for r in loop._by_rid.values()):
                        assert time.monotonic() < deadline, "nothing decoded"
                        time.sleep(0.002)
                    loop.close(drain=False)
                    results = dict(loop._by_rid)
                else:
                    results = loop.run_trace(trace, realtime=realtime)
                out["out"] = {rid: r.tokens for rid, r in results.items()}
                out["states"] = {rid: r.state.name for rid, r in results.items()}
                out["errors"] = {rid: r.error for rid, r in results.items() if r.error}
                out["keys"] = loop_keys(validate_snapshot(loop.snapshot()))
    except Exception as e:  # noqa: BLE001 — the error is the case's result
        out["error"] = f"{type(e).__name__}: {e}"
        out["cause"] = None if e.__cause__ is None else type(e.__cause__).__name__
        out["seconds"] = time.monotonic() - t0
        return out
    out["seconds"] = time.monotonic() - t0
    eng.check()
    out.update(stats=eng.flat_stats(), log=driver.log, fired=[list(f) for f in fp.fired],
               pages=home_pages(eng), swaps=swaps)
    if mesh.rank == 0:
        one = PagedEngine(cfg, params, device="cpu", config=ServeConfig(**conf))
        with _plan(plan) as rp:
            again = replay(one, driver.log)
        one.check()
        out["replay"] = {"stats": one.flat_stats(), "fired": [list(f) for f in rp.fired],
                         "out": {rid: list(r.out) for rid, r in again.requests.items()},
                         "pages": {pid: one._pack([pid]).numpy()
                                   for pid in range(1, one.pool.num_pages)}}
    return out


def loop_cases(cfg, params, mesh, n: int) -> dict:
    """The ``ServeLoop`` over ``n`` ranks: over 4, ``LOOP_MESH_TRACE`` on
    ``MESH``'s engine per mode; over 2, on ``LOOP_TWO``'s the pressured pool
    whose preempted request swaps in on the other rank, ``kv_guard`` with
    ``kernel_fallback`` under ``LOOP_PLAN``, the n-gram draft at k = 2, a
    ``close(drain=False)`` mid-trace, rejections at submit, and last a step
    that fails on rank 1 and is not retried."""
    from _torch_dist_ref import MESH, MODES

    trace = _loop_trace(cfg)
    if n == 4:
        return {mode: loop_run(cfg, params, mesh, dict(MESH, mcast_mode=mode), trace)
                for mode in MODES}
    return {
        "preempt": loop_run(cfg, params, mesh, LOOP_PRESSED, _pressed_trace()),
        "plan": loop_run(cfg, params, mesh, dict(LOOP_TWO, kv_guard=True, kernel_fallback=True),
                         trace, plan=LOOP_PLAN),
        "spec": loop_run(cfg, params, mesh, dict(LOOP_TWO, spec_k=2, draft_model="ngram"), trace),
        "abort": loop_run(cfg, params, mesh, LOOP_TWO, trace, abort=True),
        "reject": loop_run(cfg, params, mesh, LOOP_PRESSED, None, queue_cap=0,
                           submits=[(list(range(60)), 8), (list(range(40)), 8), ([1, 2, 3], 2)]),
        "broken": loop_run(cfg, params, mesh, dict(LOOP_TWO, num_shards=2), trace, broken=True),
    }


def serve_loop_realtime(params) -> dict:
    """The real-time case on 2 ranks started with ``REALTIME_TIMEOUT``:
    ``LOOP_MESH_TRACE``'s arrivals in real time, the second half
    ``REALTIME_GAP`` seconds after the first, on ``LOOP_TWO``'s engine."""
    from repro_torch.launch.mesh import make_serve_mesh

    cfg = get_config(ARCH, reduced=True)
    mesh = bind(make_serve_mesh(2))
    return loop_run(cfg, params, mesh, LOOP_TWO, _loop_trace(cfg, REALTIME_GAP), realtime=True)


def _unretried_failure(cfg, params, mesh, fallback: bool) -> dict:
    """A model step that fails on rank 1 only and is not retried: every
    suffix prefill raises there (a kernel that cannot be launched under
    ``kernel_fallback``, any error without it).  Each rank's error, and
    the seconds it took to reach it."""
    import time

    from repro_torch.kernels import KernelUnavailable
    from repro_torch.serve import PagedEngine, Request, ServeConfig

    eng = PagedEngine(cfg, params, device="cpu", mesh=mesh, config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, num_shards=2, pages_per_shard=8,
        kernel_fallback=fallback))
    if mesh.rank == 1:
        def broken(*args):
            raise (KernelUnavailable if fallback else ValueError)("planted failure on rank 1")

        eng._steps["cold_prefill"] = broken
    t0 = time.monotonic()
    try:
        eng.run([Request(rid=0, prompt=list(range(10, 22)), max_new=4, shard=0),
                 Request(rid=1, prompt=list(range(30, 42)), max_new=4, shard=1)])
    except Exception as e:  # noqa: BLE001 — the error is the result
        err = e
    else:
        err = None
    return {"error": None if err is None else f"{type(err).__name__}: {err}",
            "cause": None if err is None or err.__cause__ is None
            else type(err.__cause__).__name__, "seconds": time.monotonic() - t0}


def serve_mesh_opts(n: int, params: dict, draft_params: dict, small_params: dict,
                    opts_args: dict | None) -> dict:
    """``_torch_dist_ref.meshopt_cases`` on the port's engine over ``n``
    gloo ranks (the reduced qwen1.5-1.8b target and its 0.5b draft, each
    JAX's converted), each engine's home pages at its end; over 4 ranks
    the launcher's ranks (``_mesh_rank``) for each ``opts_args`` entry on
    the reduced qwen1.5-0.5b (``small_params``); over 2, the unretried
    failures on rank 1 and the untraced 2-rank training run."""
    import contextlib
    import io

    from _torch_dist_ref import OPTS_DRAFT, OPTS_TARGET, meshopt_cases
    from repro_torch.launch import serve as launcher
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_serve_mesh

    cfg = get_config(OPTS_TARGET, reduced=True)
    dcfg = get_config(OPTS_DRAFT, reduced=True)
    built = []
    mesh = bind(make_serve_mesh(n))
    drafts = {OPTS_DRAFT: (dcfg, draft_params), OPTS_TARGET: (cfg, params)}
    out = {"cases": meshopt_cases(port_serve_api(cfg, params, mesh, built, drafts=drafts), n)}
    out["pages"] = [home_pages(e) for e in built]
    if n == 4:
        out["launch"] = {}
        for name, argv in (opts_args or {}).items():
            got = launcher._mesh_rank(argv, small_params)
            if isinstance(got, Exception):
                out["launch"][name] = f"{type(got).__name__}: {got}"
            elif mesh.rank == 0:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    launcher.print_request_lines(got[0])
                out["launch"][name] = buf.getvalue()
        return out
    small = get_config(ARCH, reduced=True)
    out["unretried"] = {f"fallback={fb}": _unretried_failure(small, small_params, mesh, fb)
                        for fb in (False, True)}
    with contextlib.redirect_stdout(io.StringIO()):
        res = train.main(TRACE_TRAIN_ARGS)
    out["train_losses"] = None if res is None else res["losses"]
    return out


#: the 2-rank training run whose ``--trace`` is held to its untraced run
TRACE_TRAIN_ARGS = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq",
                    "16", "--steps", "2", "--log-every", "1", "--seed", "0", "--mesh-data", "2"]


def fail_on_rank_one() -> None:
    """Rank 1 raises; rank 0 waits for it in a barrier it never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("planted failure on rank 1")
    dist.barrier()


def sleep_then_return(seconds: float) -> float:
    """Sleep ``seconds``, then return them: a rank that outlives a join
    deadline shorter than that."""
    import time

    time.sleep(seconds)
    return seconds
