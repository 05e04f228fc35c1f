"""JAX-side references of the port's distribution tests, and the engine
cases both sides run.

Run as a script in its own process (``dist_reference`` in
``tests/test_torch_dist_serve.py`` and ``tests/test_torch_dist.py``), with
XLA's excess precision off, as ``_torch_jax_ref.py`` is:

    python tests/_torch_dist_ref.py {train|serve|meshserve|meshtrain|tp|dryrun} OUT.npz

* ``train``: ``lm.loss_fn`` of the reduced qwen1.5-0.5b (``lm.init`` from
  ``SEED``) on step 0's batch of the multi-rank train runs
  (``TRAIN`` of ``_torch_dist_ranks.py``), under ``backend=pallas``;
* ``serve``: :func:`engine_cases` on JAX's ``PagedEngine`` under
  ``backend=pallas`` (the engines share their jitted steps), and the JAX
  launcher's traced sharded run (``TRACE_ARGS``): its stdout and its
  ``--trace`` report;
* ``meshserve`` (4 forced host devices): :func:`mesh_cases` on JAX's
  ``PagedEngine(mesh=)`` over 4 and 2 devices, the one-device 4-shard
  engine of that workload, the launcher's ``--mesh`` stdout
  (``MESH_ARGS``); JAX's ``ServeLoop`` over ``PagedEngine(mesh=)`` on 4
  devices per mode for ``LOOP_MESH_TRACE``, and the launcher's ``--server``
  with CI's ``dist-serve-smoke`` flags (``SERVER_MESH_ARGS``), ``sync`` on
  one device and ``loop`` with ``SERVER_MESH_FLAGS``;
* ``meshtrain`` (4 forced host devices): the reduced moonshot's loss and
  aux loss on step 0's batch (``MOE_TRAIN``), and the JAX launcher's
  losses over a 2-device mesh (``MESH_TRAIN_ARGS``);
* ``tp`` (8 forced host devices): the model-axis tests' references
  (``_torch_dist_tp.py``) — each arch's ``loss_fn`` on step 0's batch
  under ``backend=pallas``, the reduced mamba2's train step on a (2, 2, 2)
  mesh (``build_train_step`` jitted with its shardings, as
  ``_multidev_main.py``'s scenarios run it) and the reduced qwen's
  ``build_prefill_step`` on a 2 x 2 mesh under ``backend=pallas`` (the
  port's kernels' numerics; the interpreted kernels partition as XLA ops).

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

    out["fork"] = fork_case(api)
    out["preempt"] = preempt_case(api)

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


def fork_case(api) -> dict:
    """A cross-shard fork over 2 shards: the child's COW copy lands on its
    own shard."""
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
    return {**fork, "out": _streams(done), "stats": _stats(eng)}


def preempt_case(api) -> dict:
    """Per-shard preemption over 2 shards: shard 0 runs dry, only its
    youngest slot yields."""
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
    return {"admitted": admitted, "victims": victims, "out": _streams(done),
            "stats": _stats(eng), "roomy": _streams(roomy.run(pinned())),
            "roomy_preempted": roomy.stats()["preempted"]}


#: the mesh engine of every mode's run over 4 ranks: ``_distserve_main.py``'s
#: engine and workload (4 requests after a 32-token prefix, 6 new tokens)
MESH = dict(max_slots=2, cache_len=64, page_size=8, num_shards=4, pages_per_shard=8)
MESH_REQUESTS = dict(n=4, shared_prefix=32, max_new=6)


def _mesh_run(eng, done) -> dict:
    """What a mesh engine's run is held to, and what only the port has
    (None on JAX's side): each chain's rounds, this rank's pool page axis."""
    eng.check()
    pages = sorted({int(t.shape[1]) for c in eng.caches for t in c}) \
        if hasattr(eng, "broadcast_rounds") else None
    return {"out": _streams(done), "stats": _stats(eng), "page_nbytes": int(eng.page_nbytes),
            "rounds": getattr(eng, "broadcast_rounds", None), "pool_pages": pages}


def mesh_cases(api, n: int) -> dict:
    """The mesh engine's runs over ``n`` ranks (``api.PagedEngine`` builds
    on the mesh): over 4, ``_distserve_main.py``'s scenario per mode; over
    2, the same workload on 4 shards (2 a rank), the cross-shard fork and
    the pressured-shard preemption, each shard on its own rank."""
    out = {}
    if n == 4:
        for mode in MODES:
            eng = api.PagedEngine(config=api.ServeConfig(**MESH, mcast_mode=mode))
            out[mode] = _mesh_run(eng, eng.run(_requests(api, **MESH_REQUESTS)))
        return out
    eng = api.PagedEngine(config=api.ServeConfig(**MESH, mcast_mode="sw_tree"))
    out["4shards"] = _mesh_run(eng, eng.run(_requests(api, **MESH_REQUESTS)))
    out["fork"] = fork_case(api)
    out["fork_late"] = fork_late_case(api)
    out["preempt"] = preempt_case(api)
    out["reroute"] = reroute_case(api)
    return out


def fork_late_case(api) -> dict:
    """A cross-shard fork whose parent copies the shared last page first
    (the older slot's step comes first): the child then writes the
    parent's original page, on the parent's shard, in place."""
    eng = api.PagedEngine(config=api.ServeConfig(max_slots=3, cache_len=64, page_size=8,
                                                 num_shards=2, pages_per_shard=8))
    parent = api.Request(rid=0, prompt=list(range(10, 22)), max_new=6, shard=0)
    assert eng._admit(parent)
    (pslot,) = eng.slots
    eng.fork(pslot, api.Request(rid=1, prompt=list(parent.prompt), max_new=6), shard=1)
    done = eng.run([])
    eng.check()
    return {"out": _streams(done), "stats": _stats(eng)}


def reroute_case(api) -> dict:
    """Unpinned requests over 2 shards of 4 pages: requests 0 and 2 share
    shard 0, request 1 (short) shard 1; request 0's page fault preempts
    request 2, which swaps back in on shard 1, by then the freer.  The
    prompts are a draw whose greedy choices have no near-tie: at prompts
    ``range(20 + 9 i, ...)`` request 1's first decode step has its top two
    logits 0.0013 apart, where the port's and JAX's one-device engines
    pick differently (each mesh engine still serves its own package's
    one-device streams)."""
    eng = api.PagedEngine(config=api.ServeConfig(max_slots=3, cache_len=64, page_size=8,
                                                 num_shards=2, pages_per_shard=4, watermark=0))
    done = eng.run([api.Request(rid=i, prompt=list(range(100 + 9 * i, 109 + 9 * i)),
                                max_new=m) for i, m in enumerate((12, 4, 12))])
    eng.check()
    return {"out": _streams(done), "stats": _stats(eng)}


#: the launcher's ``--mesh`` run: ``TRACE_ARGS`` with the pool over 4 ranks
#: (the port adds ``--device cpu``)
MESH_ARGS = [*TRACE_ARGS, "--mesh"]

#: the ``ServeLoop`` cases over a mesh: a seeded trace whose shared prefix
#: (3 pages of ``MESH``'s 8 tokens) is cached on one shard and broadcast to
#: the others, served with ``realtime=False`` on ``MESH``'s engine
LOOP_MESH_TRACE = dict(seed=3, qps=30.0, duration=0.3, max_new=6, shared_prefix_len=24,
                       shared_frac=0.5)
#: the launcher's ``--server`` over a mesh: CI's ``dist-serve-smoke`` flags
#: (the port adds ``--device cpu``); the ``sync`` oracle runs on one device,
#: the ``loop`` run adds ``SERVER_MESH_FLAGS`` and ``--metrics-json PATH``
SERVER_MESH_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--server", "--qps", "25",
                    "--duration", "0.6", "--max-slots", "3", "--seed", "5", "--max-new", "8",
                    "--shared-prefix", "24", "--kernel-policy", "backend=pallas"]
SERVER_MESH_FLAGS = ["--mesh", "--num-shards", "4", "--pages-per-shard", "16", "--mcast-mode",
                     "sw_tree"]
SERVER_MESH_SEED = 5


def loop_keys(snap: dict) -> dict:
    """The snapshot keys that do not depend on how admissions interleave
    with decode ticks: the request counts, ``tokens_out``, the submit-time
    rejections, ``num_shards`` and ``mcast_mode``."""
    fixed = ("rejected_too-long", "rejected_too-large", "rejected_queue-full", "tokens_out",
             "num_shards", "mcast_mode")
    return {k: v for k, v in snap.items() if k.startswith("requests_") or k in fixed}

#: the paged engine's options over a mesh (mode ``meshopts``): the engine of
#: the speculative pair (the reduced qwen1.5-1.8b target, the 0.5b draft)
OPTS_TARGET, OPTS_DRAFT = "qwen1.5-1.8b", "qwen1.5-0.5b"
#: each option the launcher's ``--mesh`` takes, alone, and all together
OPTS_FLAGS = {"spec": ["--spec-k", "2", "--draft-model", "ngram"], "kv_guard": ["--kv-guard"],
              "kernel_fallback": ["--kernel-fallback"], "chaos": ["--chaos", "pool.alloc:0.2"]}
OPTS_FLAGS["all"] = [a for flags in OPTS_FLAGS.values() for a in flags]
#: the launcher runs of ``meshopts``: ``MESH_ARGS`` without the trace, with
#: each of ``OPTS_FLAGS`` (the port adds ``--device cpu``)
OPTS_LAUNCH_ARGS = [a for a in MESH_ARGS if a != "--trace"]


def opts_launch_args(name: str) -> list[str]:
    return [*OPTS_LAUNCH_ARGS, *OPTS_FLAGS[name]]


def launch_or_error(launch, args: list[str]) -> str:
    """A launcher run's stdout, or the error it raises (type and message)."""
    try:
        return launch(args)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return f"{type(e).__name__}: {e}"


def _opts_run(api, conf: dict, reqs: list, plan: list | None = None, pinned=None) -> dict:
    """One engine of the options' cases serving ``reqs`` (``(rid, prompt,
    max_new)``; ``pinned``: each request's shard) under ``plan`` (a list
    of ``(site, Fault kwargs)``): the streams, the plan's fired log, the
    failed requests, the flat stats; or, where the run raises, the
    error's type and message."""
    eng = api.PagedEngine(config=api.ServeConfig(**conf))
    reqs = [api.Request(rid=r, prompt=list(p), max_new=m,
                        shard=None if pinned is None else pinned[r]) for r, p, m in reqs]
    fp = api.FaultPlan([api.Fault(site, **kw) for site, kw in plan or []], seed=SEED)
    try:
        with fp:
            done = eng.run(reqs)
    except Exception as e:  # noqa: BLE001 — the error is the case's result
        return {"error": f"{type(e).__name__}: {e}", "fired": [list(f) for f in fp.fired]}
    eng.check()
    return {"out": _streams(done), "fired": [list(f) for f in fp.fired],
            "failed": [[r.rid, r.error] for r in eng.failed], "stats": _stats(eng)}


#: the options' engines: four shards of 8 pages (``MESH``) on the target
OPTS_MESH = dict(MESH, max_slots=2)
OPTS_REQUESTS = dict(n=4, shared_prefix=32, max_new=10)


def _spec_fork(api) -> dict:
    """A cross-rank fork under speculation (2 shards, 2 ranks), the target
    its own draft, so most proposals are accepted: the child reads its
    parent's pages on the other rank and writes ``k + 1`` rows a round
    into them once it holds them alone, each page sent home."""
    eng = api.PagedEngine(config=api.ServeConfig(
        max_slots=3, cache_len=64, page_size=8, num_shards=2, pages_per_shard=8, spec_k=3,
        draft_model=OPTS_TARGET))
    parent = api.Request(rid=0, prompt=list(range(10, 22)), max_new=4, shard=0)
    assert eng._admit(parent)
    (pslot,) = eng.slots
    eng.fork(pslot, api.Request(rid=1, prompt=list(parent.prompt), max_new=12), shard=1)
    done = eng.run([])
    eng.check()
    return {"out": _streams(done), "stats": _stats(eng)}


def meshopt_cases(api, n: int) -> dict:
    """The paged engine's options over ``n`` ranks (``api.PagedEngine``
    builds the target, with its model draft where the config names one):

    * speculation, an n-gram draft at k = 2 and the model draft at k = 4,
      on ``OPTS_MESH`` (over 4 and 2 ranks); over 2 ranks also the target
      as its own draft (k = 4), whose proposals are mostly accepted (the
      random-weight draft's and the n-gram draft's are not);
    * over 4 ranks, int8 pools under ``kv_guard`` with a corrupted chain
      that later admissions on other shards hit;
    * over 2 ranks: the cross-rank fork under speculation; ``kv_guard``
      with ``page.corrupt`` on rank 0's chain that rank 1's shard then
      hits; ``kernel_fallback`` with ``kernel.raise`` on the prefill of the
      request on rank 1 and ``kernel.nan`` on a decode step; ``pool.alloc``
      exhaustion, and ``swap.drop``, under ``kv_guard`` where the preempted
      request comes back on the other rank; an injected raise that is not
      retried (the run raises)."""
    reqs = serve_requests(**OPTS_REQUESTS)
    out = {"spec_ngram": _opts_run(api, dict(OPTS_MESH, spec_k=2, draft_model="ngram"), reqs),
           "spec_model": _opts_run(api, dict(OPTS_MESH, spec_k=4, draft_model=OPTS_DRAFT),
                                   reqs)}
    if n == 4:
        out["int8_guard"] = _opts_run(
            api, dict(OPTS_MESH, kv_dtype="int8", kv_guard=True), reqs,
            [("page.corrupt", dict(at=0, page_index=2))])
        return out
    out["spec_self"] = _opts_run(api, dict(OPTS_MESH, spec_k=4, draft_model=OPTS_TARGET), reqs)
    out["spec_fork"] = _spec_fork(api)
    two = serve_requests(n=2, shared_prefix=32, max_new=6)
    out["guard_corrupt"] = _opts_run(api, dict(OPTS_MESH, kv_guard=True), two,
                                     [("page.corrupt", dict(at=0, page_index=1))],
                                     pinned=[0, 2])
    out["fallback"] = _opts_run(api, dict(OPTS_MESH, kernel_fallback=True), two,
                                [("kernel.raise", dict(at=1)), ("kernel.nan", dict(at=4))],
                                pinned=[0, 2])
    pressed = dict(max_slots=3, cache_len=64, page_size=8, num_shards=2, pages_per_shard=4,
                   watermark=0, kv_guard=True)
    rerouted = [(i, list(range(100 + 9 * i, 109 + 9 * i)), m) for i, m in enumerate((12, 4, 12))]
    out["alloc"] = _opts_run(api, pressed, rerouted, [("pool.alloc", dict(at=3))])
    out["swap_drop"] = _opts_run(api, pressed, rerouted, [("swap.drop", dict(at=0))])
    out["guarded_swap"] = _opts_run(api, pressed, rerouted)
    out["raise_unretried"] = _opts_run(api, OPTS_MESH, two, [("kernel.raise", dict(at=2))],
                                       pinned=[0, 2])
    return out


def _jax_api(cfg, params, mesh=None, drafts=None):
    """JAX's serving names as the cases take them; ``drafts``: each model
    draft's ``(cfg, params)`` by arch, passed where a config names it."""
    from types import SimpleNamespace

    from repro.serve import Fault, FaultPlan, PagedEngine, Request, ServeConfig

    def make(config=None, **kw):
        use = (drafts or {}).get(config.draft_model) if config is not None else None
        return PagedEngine(cfg, params, mesh=mesh, config=config, draft=use, **kw)

    return SimpleNamespace(PagedEngine=make, Request=Request, ServeConfig=ServeConfig,
                           Fault=Fault, FaultPlan=FaultPlan)


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


def _meshserve(out: dict) -> None:
    """``mesh_cases`` on JAX's engine over a 4- and a 2-device mesh (the
    first devices of 4 forced host devices), the one-device 4-shard
    engine of the same workload, and the launcher's ``--mesh`` stdout."""
    import jax

    from repro import kernels
    from repro.launch.mesh import make_serve_mesh

    assert jax.device_count() == 4, jax.devices()
    cfg, params = _setup()
    api = _jax_api(cfg, params)
    cases = {"loop": _mesh_loops(cfg, params)}
    with kernels.use_policy("backend=pallas"):
        for n in (4, 2):
            mesh = make_serve_mesh(n)
            mesh_api = _jax_api(cfg, params, mesh=mesh)
            cases[f"mesh{n}"] = mesh_cases(mesh_api, n)
            if n == 4:  # the page axis of every leaf split over the 4 devices
                eng = mesh_api.PagedEngine(config=mesh_api.ServeConfig(**MESH))
                cases["leaf_devices"] = sorted({len(x.sharding.device_set)
                                                for x in jax.tree.leaves(eng.caches)})
        eng = api.PagedEngine(config=api.ServeConfig(**MESH, mcast_mode="sw_tree"))
        cases["one/4shards"] = _mesh_run(eng, eng.run(_requests(api, **MESH_REQUESTS)))
    out["serve_json"] = np.asarray(json.dumps(
        {"cases": cases, "launch": _launch(MESH_ARGS), "server": _server_launches()}))


def _mesh_loops(cfg, params) -> dict:
    """JAX's ``ServeLoop`` over ``PagedEngine(mesh=)`` on the 4 devices per
    mode, ``LOOP_MESH_TRACE`` submitted back to back: the streams, the
    states and the snapshot's :func:`loop_keys`."""
    from repro import kernels
    from repro.launch.mesh import make_serve_mesh
    from repro.serve import LoadGen, PagedEngine, ServeConfig, ServeLoop

    trace = LoadGen(vocab=cfg.vocab, **LOOP_MESH_TRACE).trace()
    out = {}
    with kernels.use_policy("backend=pallas"):
        for mode in MODES:
            loop = ServeLoop(PagedEngine(cfg, params, mesh=make_serve_mesh(4),
                                         config=ServeConfig(**MESH, mcast_mode=mode)))
            results = loop.run_trace(trace, realtime=False)
            out[mode] = {"out": {str(r.rid): [int(t) for t in r.tokens]
                                 for r in results.values()},
                         "states": sorted({r.state.name for r in results.values()}),
                         "keys": loop_keys(loop.snapshot())}
    return out


def _server_launches() -> dict:
    """The launcher's ``--server`` with ``SERVER_MESH_ARGS``: the one-device
    ``sync`` oracle's stdout, and the 4-device ``--mesh`` loop run's stdout
    and metrics file."""
    import os
    import tempfile

    import jax

    from repro.configs import get_config
    from repro.models import lm

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metrics.json")
        loop = _launch([*SERVER_MESH_ARGS, "--server-driver", "loop", *SERVER_MESH_FLAGS,
                        "--metrics-json", path])
        with open(path) as f:
            metrics = json.load(f)
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    return {"sync": _launch([*SERVER_MESH_ARGS, "--server-driver", "sync"]), "loop": loop,
            "metrics": metrics,
            "params_checksum": params_checksum(lm.init(cfg, jax.random.PRNGKey(SERVER_MESH_SEED)))}


def _meshopts(out: dict) -> None:
    """``meshopt_cases`` on JAX's ``PagedEngine(mesh=)`` over a 4- and a
    2-device mesh, and the launcher's ``--mesh`` stdout with each of
    ``OPTS_FLAGS``."""
    import jax

    from repro import kernels
    from repro.launch.mesh import make_serve_mesh

    assert jax.device_count() == 4, jax.devices()
    cfg, params = _setup(OPTS_TARGET)
    draft = _setup(OPTS_DRAFT)
    cases = {}
    with kernels.use_policy("backend=pallas"):
        for n in (4, 2):
            cases[f"mesh{n}"] = meshopt_cases(_jax_api(
                cfg, params, mesh=make_serve_mesh(n),
                drafts={OPTS_DRAFT: draft, OPTS_TARGET: (cfg, params)}), n)
    launch = {name: launch_or_error(_launch, opts_launch_args(name)) for name in OPTS_FLAGS}
    out["serve_json"] = np.asarray(json.dumps({"cases": cases, "launch": launch}))
    out["draft_checksum"] = np.asarray(params_checksum(draft[1]))
    out["target_checksum"] = np.asarray(params_checksum(params))


#: the launcher's 2-rank mesh run (the port adds ``--device cpu``, its
#: ``--ckpt-dir`` and ``--kernel-policy reference``, JAX's CPU default)
MESH_TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "4", "--seq", "16",
                   "--steps", "2", "--log-every", "1", "--seed", str(SEED), "--mesh-data", "2"]


def _meshtrain(out: dict) -> None:
    """The reduced moonshot's ``lm.loss_fn`` and aux loss on step 0's
    global batch under ``backend=pallas``; and the JAX launcher's
    ``train_loop`` over a 2-device mesh (``MESH_TRAIN_ARGS``), whose batch
    ``sharded_batch`` draws per shard."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from _torch_dist_ranks import MOE_TRAIN
    from _torch_jax_ref import _train_launch
    from repro import kernels
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, global_batch_np
    from repro.models import lm

    assert jax.device_count() == 4, jax.devices()
    cfg = get_config(MOE_TRAIN["arch"], reduced=True)
    params = lm.init(cfg, jax.random.PRNGKey(SEED))
    batch = global_batch_np(DataConfig(vocab=cfg.vocab, seq_len=MOE_TRAIN["seq"],
                                       global_batch=MOE_TRAIN["batch"],
                                       seed=MOE_TRAIN["seed"]), 0)
    toks, labels = jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"])
    with kernels.use_policy("backend=pallas"):
        loss = jax.jit(lambda p: lm.loss_fn(p, cfg, toks, labels, loss_chunk=None))(params)
        aux = jax.jit(lambda p: lm.forward(p, cfg, toks)[1])(params)
    out["moe_loss0"], out["moe_aux0"] = np.asarray(loss), np.asarray(aux)
    out["moe_params_checksum"] = np.asarray(params_checksum(params))
    with tempfile.TemporaryDirectory() as d:
        res, _, err = _train_launch([*MESH_TRAIN_ARGS, "--ckpt-dir", d])
    assert err == "", err
    out["launch_losses"] = np.asarray(res["losses"], np.float64)


def _tp(out: dict) -> None:
    """The ``tp`` mode (module docstring)."""
    import jax
    import jax.numpy as jnp

    import _torch_dist_tp as tpr
    import repro.configs.shapes as shapes_mod
    from repro import kernels
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCfg
    from repro.dist.step import build_prefill_step, build_train_step
    from repro.launch.mesh import make_debug_mesh
    from repro.models import encdec, lm
    from repro.optim import adamw

    assert jax.device_count() == 8, jax.devices()
    for arch in (*tpr.ARCHS, tpr.MAMBA):
        cfg = get_config(arch, reduced=True)
        mod = encdec if cfg.family == "audio" else lm
        params = mod.init(cfg, jax.random.PRNGKey(SEED))
        b = tpr.batch_np(cfg, 0)
        toks, labels = jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])
        if "frames" in b:
            frames = jnp.asarray(b["frames"], jnp.bfloat16)
            fn = lambda p: encdec.loss_fn(p, cfg, toks, labels, frames)  # noqa: E731
        else:
            fn = lambda p: lm.loss_fn(p, cfg, toks, labels, loss_chunk=None)  # noqa: E731
        with kernels.use_policy("backend=pallas"):
            out[f"loss0/{arch}"] = np.asarray(jax.jit(fn)(params))
        out[f"checksum/{arch}"] = np.asarray(params_checksum(params))

    # mamba2's step on (pod, data, model) = (2, 2, 2): its batch over (data, model)
    cfg = get_config(tpr.MAMBA, reduced=True)
    shapes_mod.SHAPES["tptrain"] = ShapeCfg("tptrain", "train", tpr.TRAIN["seq"],
                                            tpr.TRAIN["batch"])
    mesh = make_debug_mesh(2, 2, pod=2)
    bundle = build_train_step(cfg, mesh, "tptrain",
                              opt_cfg=adamw.AdamWConfig(lr=tpr.TRAIN["lr"], warmup_steps=5,
                                                        total_steps=tpr.TRAIN["steps"]),
                              loss_chunk=None)
    params = lm.init(cfg, jax.random.PRNGKey(SEED))
    b = tpr.batch_np(cfg, 0)
    with jax.set_mesh(mesh):
        step = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                       out_shardings=bundle.out_shardings)
        opt = adamw.init(params, adamw.AdamWConfig())
        batch = {"tokens": jnp.asarray(b["tokens"]), "labels": jnp.asarray(b["labels"])}
        args = jax.device_put((params, opt, batch, jnp.int32(0)), bundle.in_shardings)
        _, _, loss, _ = step(*args)
    out["mesh_loss0/mamba"] = np.asarray(loss)

    # qwen's prefill on 2 x 2
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    shapes_mod.SHAPES["tpprefill"] = ShapeCfg("tpprefill", "prefill", tpr.PREFILL["seq"],
                                              tpr.PREFILL["batch"])
    mesh = make_debug_mesh(2, 2)
    bundle = build_prefill_step(cfg, mesh, "tpprefill")
    params = lm.init(cfg, jax.random.PRNGKey(SEED))
    with jax.set_mesh(mesh), kernels.use_policy("backend=pallas"):
        fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings)
        args = jax.device_put(
            (params, {"tokens": jnp.asarray(tpr.prefill_tokens(cfg).numpy())}),
            bundle.in_shardings)
        logits, _ = fn(*args)
    out["prefill_logits"] = np.asarray(logits, np.float32)


def _dryrun(out: dict) -> None:
    """The ``dryrun`` mode: for the reduced qwen's cells of
    ``_torch_dist_tp.DRY_CELLS`` on each debug mesh, the compiled step's
    ``memory_summary``, collective counts and bytes (``launch/hlo.py``,
    unchanged); and the one-device prefill's dot FLOPs of each
    ``FLOP_ARCHS`` arch."""
    import jax

    import _torch_dist_tp as tpr
    import repro.configs.shapes as shapes_mod
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCfg
    from repro.dist.step import build_step
    from repro.launch.hlo import analyze_compiled, memory_summary
    from repro.launch.mesh import make_debug_mesh

    assert jax.device_count() == 8, jax.devices()
    for name, (kind, seq, batch) in tpr.DRY_SHAPES.items():
        shapes_mod.SHAPES[name] = ShapeCfg(name, kind, seq, batch)

    def compile_(cfg, mesh, shape, kw):
        bundle = build_step(cfg, mesh, shape, **kw)
        with jax.set_mesh(mesh):
            return jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                           out_shardings=bundle.out_shardings
                           ).lower(*bundle.abstract_inputs).compile()

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    cells = {}
    for mname, (data, model, pod) in tpr.DRY_MESHES.items():
        mesh = make_debug_mesh(data, model, pod=pod)
        for cname, (shape, kw) in tpr.DRY_CELLS.items():
            compiled = compile_(cfg, mesh, shape, kw)
            an = analyze_compiled(compiled, mesh.size)
            cells[f"{mname}/{cname}"] = {
                "memory": memory_summary(compiled), "counts": an["collective_counts"],
                "bytes": an["collective_bytes_by_op"]}
    flops = {}
    for arch in tpr.FLOP_ARCHS:
        compiled = compile_(get_config(arch, reduced=True), make_debug_mesh(1, 1), "dprefill", {})
        flops[arch] = analyze_compiled(compiled, 1)["dot_flops"]
    out["dryrun_json"] = np.asarray(json.dumps({"cells": cells, "flops": flops}))


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
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false"
                        + (f" --xla_force_host_platform_device_count={MESH_MODES[mode]}"
                           if mode in MESH_MODES else "")).strip()
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


#: the modes that run on forced host devices, and how many
MESH_MODES = {"meshserve": 4, "meshopts": 4, "meshtrain": 4, "tp": 8, "dryrun": 8}


def main(mode: str, path: str) -> None:
    out: dict = {}
    if mode in ("serve", "meshserve", "meshopts"):
        _share_jits()
    {"serve": _serve, "train": _train, "meshserve": _meshserve, "meshopts": _meshopts,
     "meshtrain": _meshtrain, "tp": _tp, "dryrun": _dryrun}[mode](out)
    _, params = _setup()
    out["params_checksum"] = np.asarray(params_checksum(params))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
