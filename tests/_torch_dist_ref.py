"""JAX-side references of the port's distribution tests, and the engine
cases both sides run.

Run as a script in its own process (``dist_reference`` in
``tests/test_torch_dist_serve.py`` and ``tests/test_torch_dist.py``), with
XLA's excess precision off, as ``_torch_jax_ref.py`` is:

    python tests/_torch_dist_ref.py {train|serve} OUT.npz

* ``train``: ``lm.loss_fn`` of the reduced qwen1.5-0.5b (``lm.init`` from
  ``SEED``) on step 0's batch of the multi-rank train runs
  (``TRAIN`` of ``_torch_dist_ranks.py``), under ``backend=pallas``;
* ``serve``: :func:`engine_cases` on JAX's ``PagedEngine`` under
  ``backend=pallas`` (the engines share their jitted steps), and the JAX
  launcher's traced sharded run (``TRACE_ARGS``): its stdout and its
  ``--trace`` report.

:func:`engine_cases` takes a package's serving names (``api``), so the
port's test runs the very same cases on the port.
"""
from __future__ import annotations

import json
import sys

import numpy as np

from _torch_jax_ref import SEED, _launch, _setup, _share_jits, params_checksum, serve_requests

#: the four-shard engine of every mode's run
SHARDED = dict(max_slots=2, cache_len=64, num_shards=4, pages_per_shard=8)
MODES = ("unicast", "sw_tree", "hw")

#: the traced launcher run of mode ``serve``: the sharded pool broadcasting
#: the shared prefix under sw_tree (the port adds ``--device cpu`` and its
#: own ``--trace PATH``)
TRACE_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "6", "--max-new", "6",
              "--shared-prefix", "32", "--seed", str(SEED), "--kv", "paged",
              "--kernel-policy", "backend=pallas", "--num-shards", "4", "--mcast-mode",
              "sw_tree", "--page-size", "8", "--max-batch", "2", "--cache-len", "64"]


def _requests(api, **kw):
    shards = kw.pop("shards", None)
    return [api.Request(rid=r, prompt=p, max_new=m,
                        shard=None if shards is None else shards[r])
            for r, p, m in serve_requests(**kw)]


def _streams(done) -> dict:
    return {str(r.rid): [int(t) for t in r.out] for r in done}


def _stats(eng) -> dict:
    return {k: v for k, v in eng.flat_stats().items() if not k.startswith("kernel_calls")}


def engine_cases(api) -> dict:
    """The sharded-engine runs held between the packages, by name: each
    run's streams and flat stats (and what the case itself reads).
    ``api`` names ``PagedEngine`` (a callable taking the JAX engine's
    arguments), ``Request``, ``ServeConfig``, ``Fault`` and ``FaultPlan``."""
    out = {}
    for mode in MODES:
        for name, req_kw, conf in (
                ("cold", dict(n=5, shared_prefix=0, max_new=5), dict(page_size=16)),
                ("prefix", dict(n=4, shared_prefix=32, max_new=5), dict(page_size=8))):
            eng = api.PagedEngine(config=api.ServeConfig(**SHARDED, **conf, mcast_mode=mode))
            done = eng.run(_requests(api, **req_kw))
            eng.check()
            out[f"{name}/{mode}"] = {"out": _streams(done), "stats": _stats(eng),
                                     "page_nbytes": int(eng.page_nbytes)}

    # cross-shard fork: the child's COW copy lands on its own shard
    eng = api.PagedEngine(config=api.ServeConfig(max_slots=3, cache_len=64, page_size=8,
                                                 num_shards=2, pages_per_shard=8))
    parent = api.Request(rid=0, prompt=list(range(10, 22)), max_new=6, shard=0)
    assert eng._admit(parent)
    (pslot,) = eng.slots
    cslot = eng.fork(pslot, api.Request(rid=1, prompt=list(parent.prompt), max_new=6), shard=1)
    cst = eng.slots[cslot]
    need = cst.length // eng.page_size
    shared_pid = cst.pages[need]
    fork = {"child_shard": cst.shard, "zero_copy": cst.pages == eng.slots[pslot].pages,
            "shared_refs": eng.pool.refcount(shared_pid), "writable": eng._ensure_writable(cslot)}
    fork["new_page_shard"] = eng.pool.shard_of(cst.pages[need])
    fork["moved"] = cst.pages[need] != shared_pid
    done = eng.run([])
    eng.check()
    out["fork"] = {**fork, "out": _streams(done), "stats": _stats(eng)}

    # per-shard preemption: shard 0 runs dry, only its youngest slot yields
    def pinned():
        return [api.Request(rid=0, prompt=list(range(30, 39)), max_new=10, shard=0),
                api.Request(rid=1, prompt=list(range(40, 49)), max_new=10, shard=0),
                api.Request(rid=2, prompt=list(range(50, 59)), max_new=10, shard=1)]

    eng = api.PagedEngine(config=api.ServeConfig(max_slots=3, cache_len=64, page_size=8,
                                                 num_shards=2, pages_per_shard=4, watermark=0))
    a, b, c = pinned()
    admitted = [bool(eng._admit(a)), bool(eng._admit(b)), bool(eng._admit(c))]
    by_rid = {st.req.rid: s for s, st in eng.slots.items()}
    victims = [eng._pick_victim(shard=0) == by_rid[1], eng._pick_victim(shard=1) == by_rid[2]]
    done = eng.run([])
    eng.check()
    roomy = api.PagedEngine(config=api.ServeConfig(max_slots=3, cache_len=64, page_size=8,
                                                   num_shards=2, pages_per_shard=16,
                                                   watermark=0))
    out["preempt"] = {"admitted": admitted, "victims": victims, "out": _streams(done),
                      "stats": _stats(eng), "roomy": _streams(roomy.run(pinned())),
                      "roomy_preempted": roomy.stats()["preempted"]}

    # one shard's alloc fault degrades without touching the other's streams
    guarded = dict(max_slots=3, cache_len=64, page_size=8, num_shards=2, pages_per_shard=12,
                   kv_guard=True)
    kw = dict(n=4, shared_prefix=16, max_new=5, shards=[0, 0, 1, 1])
    calm = api.PagedEngine(config=api.ServeConfig(**guarded))
    expect = _streams(calm.run(_requests(api, **kw)))
    eng = api.PagedEngine(config=api.ServeConfig(**guarded))
    plan = api.FaultPlan([api.Fault("pool.alloc", at=1, count=2)])
    with plan:
        done = eng.run(_requests(api, **kw))
    eng.check()
    out["fault"] = {"calm": expect, "out": _streams(done), "fired": [list(f) for f in plan.fired],
                    "stats": _stats(eng)}

    # stats_delta: counters as deltas, every shard{s}_* gauge as its value
    for n in (1, 4):
        eng = api.PagedEngine(config=api.ServeConfig(
            max_slots=2, cache_len=64, page_size=8, num_shards=n,
            pages_per_shard=8 if n > 1 else None))
        eng.run(_requests(api, n=4, shared_prefix=16, max_new=5))
        d1 = {k: v for k, v in eng.stats_delta().items() if not k.startswith("kernel_calls")}
        d2 = {k: v for k, v in eng.stats_delta().items() if not k.startswith("kernel_calls")}
        out[f"delta/{n}"] = {"d1": d1, "d2": d2, "now": _stats(eng)}
    return out


def _jax_api(cfg, params):
    from types import SimpleNamespace

    from repro.serve import Fault, FaultPlan, PagedEngine, Request, ServeConfig

    return SimpleNamespace(
        PagedEngine=lambda **kw: PagedEngine(cfg, params, **kw), Request=Request,
        ServeConfig=ServeConfig, Fault=Fault, FaultPlan=FaultPlan)


def _serve(out: dict) -> None:
    import os
    import tempfile

    from repro import kernels

    cfg, params = _setup()
    with kernels.use_policy("backend=pallas"):
        cases = engine_cases(_jax_api(cfg, params))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "jax_trace.json")
        stdout = _launch([*TRACE_ARGS, "--trace", path])
        with open(path + ".report.json") as f:
            report = json.load(f)
    out["serve_json"] = np.asarray(json.dumps(
        {"cases": cases, "trace": {"stdout": stdout, "report": report}}))


def _train(out: dict) -> None:
    import jax
    import jax.numpy as jnp

    from _torch_dist_ranks import TRAIN
    from repro import kernels
    from repro.data.pipeline import DataConfig, global_batch_np
    from repro.models import lm

    cfg, params = _setup()
    batch = global_batch_np(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                       global_batch=TRAIN["batch"], seed=TRAIN["seed"]), 0)
    with kernels.use_policy("backend=pallas"):
        loss = jax.jit(lambda p: lm.loss_fn(p, cfg, jnp.asarray(batch["tokens"]),
                                            jnp.asarray(batch["labels"]), loss_chunk=None))(params)
    out["loss0"] = np.asarray(loss)


def reference(mode: str, tmp_dir) -> dict:
    """Run this script's ``mode`` in a child process, as
    ``_torch_util.jax_reference`` runs ``_torch_jax_ref.py``, and return
    its arrays."""
    import os
    import subprocess
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    out = Path(tmp_dir) / f"jax_dist_{mode}.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["REPRO_AUTOTUNE_CACHE"] = str(Path(tmp_dir) / f"autotune_dist_{mode}.json")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(tests.parent / "src"), env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, str(tests / "_torch_dist_ref.py"), mode, str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"JAX reference (dist {mode}) failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def main(mode: str, path: str) -> None:
    out: dict = {}
    if mode == "serve":
        _share_jits()
    {"serve": _serve, "train": _train}[mode](out)
    _, params = _setup()
    out["params_checksum"] = np.asarray(params_checksum(params))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
