"""Serving launcher of the port: continuous batching on the card.

``python -m repro_torch.launch.serve`` takes the JAX launcher's flags for
the paths the port runs (``--arch --reduced --requests --max-new
--max-batch --shared-prefix --kv --kernel-policy`` and every
:class:`ServeConfig` field) plus ``--device`` (default ``cuda``), builds
the same seeded requests and prints the same ``req …`` lines on stdout,
so the two launchers' outputs can be diffed when they serve the same
weights (:func:`main` takes ``params=`` for that).  Two KV backends, as
in the JAX launcher:

* ``--kv dense`` (the default): :class:`Server`, one ring-buffer cache
  slot per batch lane, prefill (bucketed where padding is exact: not for
  MoE, recurrent mixers or local windows) written in place into the
  slot; every arch of the registry, the MoE ones
  (moonshot-v1-16b-a3b, llama4-maverick-400b-a17b), the SSD model
  mamba2-780m and the RG-LRU / local-attention hybrid recurrentgemma-2b
  (their recurrent states and window rings written into the slot too);
* ``--kv paged``: :class:`PagedEngine`, the page pool with prefix
  sharing (its statistics go to stderr), with bf16 or int8 pools
  (``--kv-dtype``) and speculative decoding (``--spec-k K --draft-model
  ngram|<arch>|auto``; ``auto`` resolves the target's registered draft,
  whose parameters are initialised from the run's seed on the same
  device); MoE, recurrent and local-window archs raise JAX's
  ``ValueError`` here (expert capacity scales with the padded call
  length, so paged prefills would route real tokens differently; a
  recurrent state or a ring has no pages).

``--kernel-policy`` forces the matmul schedule as in the JAX launcher:
``tiled`` (K1), ``mcast`` (K4), ``unicast`` (K5); the default is the
cost model's pick (``backend=pallas``), and ``reference`` runs every
family's plain-PyTorch oracle.  A forced matmul schedule cannot reach
the paged engine: its attention op has no such schedule and raises, as
in the JAX package.  ``--kv-guard`` (page fingerprints), ``--kernel-fallback``
(retry a failed or non-finite step once on the reference backend,
counted in the engine's stats; off by default) and ``--chaos
SITE[:PROB]`` (a seeded fault plan) reach the paged engine.

``--server`` switches from the fixed request list to the async
continuous-batching loop (:class:`~repro_torch.serve.ServeLoop`, paged
engine only): a seeded Poisson trace (``--qps``, ``--duration``,
``--seed``, the shared-prefix mix of ``--shared-prefix`` /
``--shared-frac``) arrives in real time, prefills land between decode
ticks, and every request streams its tokens.  ``--server-driver sync``
replays the same trace through the synchronous ``PagedEngine.run``:
both drivers print the same ``req …`` lines.  The loop validates its
flat metrics snapshot against the schema (printed to stderr; written to
``--metrics-json`` when given), and without ``--chaos`` fails unless
every request drained.  ``--queue-cap`` bounds the loop's queue.

``--trace PATH`` arms a recorder (:mod:`repro_torch.obs.trace`) before
the engine is built and writes, even when the run ends in a
``SystemExit``, the Chrome/Perfetto trace at ``PATH`` (``.jsonl``: one
event per line) and beside it ``PATH.report.json``, the
multicast-efficiency report of :mod:`repro_torch.obs.analyze`, validated
against its schema; the status line goes to stderr, stdout stays the
token-stream surface.

``--num-shards S --mcast-mode {unicast,sw_tree,hw} [--pages-per-shard
N] [--mesh-axis A]`` turn on the sharded page pool with page-chain
broadcast (``--kv paged``), on one device as in the JAX launcher without
``--mesh``.  ``--mesh`` splits the pool over a 1-D mesh of ``S`` ranks on
``--mesh-axis`` (``PagedEngine(mesh=)``), which the launcher starts
(``dist/spawn.py``): gloo ranks on ``--device cpu``, one NCCL rank per
card on ``cuda`` — more ranks than cards raise, naming the count, with no
fallback from NCCL to gloo.  Rank 0 returns the streams and the stats,
which this process prints as the one-device run does (its stdout equals
the JAX launcher's with ``--mesh`` on as many devices); ``--trace``
records rank 0.  ``--mesh`` needs ``--kv paged``.  It takes ``--spec-k``
with ``--draft-model`` (each rank builds the model draft's copy from the
run's seed), ``--kv-guard``, ``--kernel-fallback`` and ``--chaos`` (the
plan armed alike on every rank), and ``--server``: ``--server-driver
sync`` runs ``PagedEngine.run`` of the trace on every rank; ``loop`` runs
the ``ServeLoop`` on rank 0 (the trace, the validated snapshot,
``--metrics-json``) while every other rank follows its engine calls
(``serve.server.follow``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 8 --max-new 32 --shared-prefix 32 [--kernel-policy mcast]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --device cpu --shared-prefix 24 --kv paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-1.8b \\
        --kv paged --kv-dtype int8 --spec-k 4 --draft-model auto
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        [--kernel-policy mcast]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --server --qps 1.5 --duration 6 --max-slots 4 --shared-prefix 32 \\
        [--server-driver sync] [--kv-guard --kernel-fallback --chaos pool.alloc]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --kv paged --shared-prefix 32 --trace /tmp/serve.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --device cpu --kv paged --shared-prefix 32 --num-shards 4 \\
        --mcast-mode sw_tree --mesh [--spec-k 2 --draft-model ngram] [--kv-guard] \\
        [--kernel-fallback] [--chaos kernel.nan:0.2]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --device cpu --server --qps 25 --duration 0.6 --max-slots 3 \\
        --seed 5 --max-new 8 --shared-prefix 24 --mesh --num-shards 4 \\
        --pages-per-shard 16 --mcast-mode sw_tree --metrics-json /tmp/m.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback

import numpy as np
import torch

from repro_torch import kernels, tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.registry import draft_for
from repro_torch.device import DEFAULT, resolve
from repro_torch.models import lm
from repro_torch.serve import (
    Lifecycle,
    LoadGen,
    PagedEngine,
    Request,
    Sampler,
    ServeLoop,
    ServeMetrics,
    add_serve_args,
    get_sampler,
    pad_to_bucket,
    validate_snapshot,
)
from repro_torch.serve import config as serve_config


class Server:
    """Continuous-batching decode server over dense ring-buffer KV caches
    (``--kv dense``): the port of the JAX launcher's ``Server``.

    Each admitted request prefills alone, right-padded to a
    ``prompt_bucket`` multiple, with the padded tail masked out of its
    cache, where padding is exact: global attention everywhere and no MoE
    (expert capacity scales with the padded length, so pads would take
    capacity and change real tokens' routing), the JAX launcher's rule;
    otherwise (MoE, a local window, a recurrent mixer) the prompt
    prefills at its own length.  The caches — rings, and the recurrent
    layers' states — are written in place into the request's batch slot.
    Every decode step runs all ``max_batch`` slots at their own positions
    (ragged continuous batching).  ``params`` must live on ``device``."""

    def __init__(self, cfg, params, *, max_batch: int = 4, cache_len: int = 256,
                 prompt_bucket: int = 16, sampler: Sampler | None = None,
                 device: str | torch.device = DEFAULT):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.device = resolve(device)
        self.sampler = sampler if sampler is not None else get_sampler("greedy")
        self.caches = lm.init_cache(cfg, max_batch, cache_len, device=self.device)
        self.active: dict[int, Request] = {}  # slot -> request
        self.pos = np.zeros(max_batch, np.int32)
        self.last_tok = np.zeros(max_batch, np.int32)
        # right-pad-to-bucket prefill is exact only when padded tokens
        # cannot influence real ones: global attention (no ring wrap), no
        # recurrent mixer state, and no MoE (expert capacity scales with
        # the padded length, so pads would consume capacity and change
        # real tokens' routing)
        self._bucket = prompt_bucket if all(
            bd.mixer == "attn" and bd.window is None and bd.ff != "moe"
            for bd in cfg.layer_defs
        ) else None

    def _admit(self, req: Request) -> bool:
        free = [s for s in range(self.max_batch) if s not in self.active]
        if not free:
            return False
        slot = free[0]
        n = len(req.prompt)
        toks = torch.as_tensor(pad_to_bucket(req.prompt, self._bucket) if self._bucket
                               else np.asarray(req.prompt, np.int32)[None],
                               device=self.device).long()
        logits, one = lm.prefill(self.params, self.cfg, toks, cache_slots=self.cache_len,
                                 logit_index=n - 1)
        # bucket padding wrote K/V rows past the prompt: mark them empty
        for full, c in zip(self.caches, lm.mask_cache_after(one, n)):
            for dst, src in zip(full, c):  # in-place slot write; axis 0 is the batch
                dst[slot:slot + 1] = src
        self.active[slot] = req
        self.pos[slot] = n
        self.last_tok[slot] = int(self.sampler.select(logits)[0, -1])
        req.out.append(int(self.last_tok[slot]))
        return True

    def run(self, requests: list[Request]) -> list[Request]:
        queue = list(requests)
        done: list[Request] = []
        while queue or self.active:
            while queue and self._admit(queue[0]):
                queue.pop(0)
            if not self.active:
                continue
            toks = torch.as_tensor(self.last_tok, device=self.device).long()[:, None]
            idx = torch.as_tensor(self.pos, device=self.device).long()
            logits, self.caches = lm.decode_step(self.params, self.cfg, self.caches, toks, idx)
            nxt = self.sampler.select(logits)[:, -1]
            finished = []
            for slot, req in list(self.active.items()):
                self.pos[slot] += 1
                self.last_tok[slot] = nxt[slot]
                req.out.append(int(nxt[slot]))
                if len(req.out) >= req.max_new:
                    finished.append(slot)
            for slot in finished:
                done.append(self.active.pop(slot))
        return done


def make_requests(cfg, *, n: int, max_new: int, shared_prefix: int, seed: int):
    """The JAX launcher's request list, from the same numpy seed."""
    rng = np.random.default_rng(seed)
    prefix = list(rng.integers(0, cfg.vocab, size=shared_prefix))
    return [
        Request(rid=i,
                prompt=prefix + list(rng.integers(0, cfg.vocab, size=rng.integers(4, 12))),
                max_new=max_new)
        for i in range(n)
    ]


def print_request_lines(done: list[Request]) -> None:
    """stdout is the parity surface with the JAX launcher."""
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {len(r.out)} "
              f"tokens: {r.out[:8]}...")
    print(f"served {len(done)} requests with continuous batching")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCHS, default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--server", action="store_true",
                    help="async continuous-batching server loop (ServeLoop) over a "
                         "seeded Poisson trace; requires --kv paged")
    ap.add_argument("--qps", type=float, default=4.0,
                    help="--server: mean Poisson arrival rate")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="--server: trace length in seconds")
    ap.add_argument("--shared-frac", type=float, default=0.5,
                    help="--server: fraction of requests opening with the "
                         "--shared-prefix tokens")
    ap.add_argument("--server-driver", choices=("loop", "sync"), default="loop",
                    help="--server: 'loop' runs the async ServeLoop; 'sync' replays the "
                         "same trace through PagedEngine.run (the token-parity oracle)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="--server loop: write the validated flat metrics snapshot here")
    ap.add_argument("--kv", choices=("dense", "paged"), default=None,
                    help="KV-cache backend: dense ring buffers, or the paged pool "
                         "with prefix sharing; default dense, or paged under --server")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common random prefix of this many tokens "
                         "to every request (exercises prefix sharing and the "
                         "chunked suffix prefill)")
    ap.add_argument("--kernel-policy", default=None,
                    help='kernel dispatch policy, e.g. "mcast", "unicast", "tiled" or '
                         '"backend=pallas" (see repro_torch.kernels.api)')
    ap.add_argument("--device", default=DEFAULT,
                    help="torch device: cuda (the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--mesh", action="store_true",
                    help="paged: split the page pool over a --num-shards 1-D mesh of ranks "
                         "this launcher starts (gloo on --device cpu, NCCL on cuda)")
    # every ServeConfig knob becomes a flag, one definition (serve/config.py)
    add_serve_args(ap)
    return ap


def _parse(argv: list[str] | None):
    """The parsed flags, their defaults resolved and their pairings checked."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.kv is None:
        args.kv = "paged" if args.server else "dense"
    if args.server and args.kv != "paged":
        ap.error("--server requires --kv paged (the ServeLoop is built on the paged "
                 "engine's typed admission/slot machinery)")
    if args.draft_model == "auto":
        # resolve the registry pairing before ServeConfig validation,
        # which never sees "auto"
        paired = draft_for(args.arch)
        if paired is None:
            ap.error(f"--draft-model auto: registry pairs no draft for --arch {args.arch}")
        args.draft_model = paired
    if args.spec_k and args.kv != "paged":
        ap.error("--spec-k requires --kv paged (speculative verify-accept "
                 "runs on the paged engine's COW page machinery)")
    if args.mesh and args.kv != "paged":
        ap.error("--mesh requires --kv paged (it splits the page pool over ranks)")
    serve_cfg = serve_config.from_args(
        args, max_slots=(args.max_slots or args.max_batch) if args.server else args.max_batch)
    return args, serve_cfg


def main(argv: list[str] | None = None, *, params=None, draft_params=None,
         timeout: float | None = None, join_timeout: float | None = None) -> list[Request]:
    """Run the launcher; ``params`` (on the chosen device; on the CPU
    under ``--mesh``, each rank taking a copy) replaces the seeded random
    init, e.g. weights converted by ``repro_torch.weights``, and
    ``draft_params`` likewise the model draft's.  Returns the served
    (under ``--server``: the drained) requests.  ``timeout`` and
    ``join_timeout`` bound the ranks of ``--mesh`` as ``spawn.run``'s
    do; by default torch's process-group timeout and no join deadline."""
    args, serve_cfg = _parse(argv)
    if args.mesh:
        return _serve_mesh(list(argv if argv is not None else sys.argv[1:]), args, serve_cfg,
                           params, draft_params, timeout, join_timeout)
    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve(args.device)
    rec = _arm_trace(serve_cfg)
    try:
        return _drive(args, cfg, serve_cfg, device, params, draft_params)
    finally:
        # the trace lands even on a SystemExit from undrained requests:
        # the failing run is the one worth reading
        if rec is not None:
            _finish_trace(rec, serve_cfg.trace)


def _drive(args, cfg, serve_cfg, device, params, draft_params) -> list[Request]:
    """Build the model and the server ``args`` ask for, and serve."""
    if params is None:
        params = lm.init(cfg, seed=serve_cfg.seed, device=device)
    sampler = get_sampler(serve_cfg.sampler)
    policy = (kernels.use_policy(args.kernel_policy) if args.kernel_policy
              else contextlib.nullcontext())
    with policy:
        if args.kv == "paged":
            server = PagedEngine(cfg, params, config=serve_cfg, sampler=sampler,
                                 draft=_draft(args, serve_cfg, draft_params, device),
                                 device=device)
        else:
            server = Server(cfg, params, max_batch=serve_cfg.max_slots, sampler=sampler,
                            device=device)
        if args.server:
            return run_server(args, cfg, serve_cfg, server)
        reqs = make_requests(cfg, n=args.requests, max_new=args.max_new,
                             shared_prefix=args.shared_prefix, seed=serve_cfg.seed)
        with serve_cfg.fault_plan() or contextlib.nullcontext():
            done = server.run(reqs)
    print_request_lines(done)
    if args.kv == "paged":
        print(f"# paged kv stats: {server.stats()}", file=sys.stderr)
    return done


def _draft(args, serve_cfg, draft_params, device):
    """The model draft's ``(cfg, params)`` when the flags ask for one:
    ``draft_params`` (on ``device``), else a second parameter set from the
    run's seed, so the whole configuration replays from the flags."""
    if not serve_cfg.spec_k or serve_cfg.draft_model == "ngram":
        return None
    dcfg = get_config(serve_cfg.draft_model, reduced=args.reduced)
    if draft_params is None:
        draft_params = lm.init(dcfg, seed=serve_cfg.seed, device=device)
    return dcfg, draft_params


def _serve_mesh(argv, args, serve_cfg, params, draft_params, timeout,
                join_timeout) -> list[Request]:
    """``--mesh``: ``--num-shards`` ranks serve the requests together (rank
    0's streams and stats come back); printed as the one-device run
    prints them."""
    import torch.distributed as dist

    from repro_torch.dist import spawn
    from repro_torch.launch.serve import _mesh_rank  # by name, also under -m

    backend = "nccl" if resolve(args.device).type == "cuda" else "gloo"
    if timeout is None:
        timeout = dist.default_pg_timeout.total_seconds()
    got = spawn.run(_mesh_rank, serve_cfg.num_shards, argv, params, draft_params,
                    backend=backend, timeout=timeout, join_timeout=join_timeout)[0]
    if isinstance(got, Exception):
        raise got
    if args.server:
        return report_server(args, serve_cfg, got)
    done, stats = got
    print_request_lines(done)
    print(f"# paged kv stats: {stats}", file=sys.stderr)
    return done


def _mesh_rank(argv: list[str], params=None, draft_params=None):
    """One rank of ``--mesh``: the paged engine over the 1-D mesh of every
    rank, serving the seeded requests under the run's fault plan (armed
    alike on every rank); rank 0 returns (the finished requests,
    ``stats()``) and records the trace, the others None.  Under
    ``--server`` the seeded trace instead, by :func:`serve_trace` (with the
    ``loop`` driver the other ranks follow rank 0's loop); rank 0 returns
    what :func:`report_server` prints.  Every rank takes the same host
    decisions, so an error the run raises is raised on every rank alike:
    rank 0 returns it, for the launcher to raise."""
    from repro_torch.launch.mesh import bind, make_serve_mesh

    args, serve_cfg = _parse(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = bind(make_serve_mesh(serve_cfg.num_shards, axis=serve_cfg.mesh_axis))
    device = resolve(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    if params is None:
        params = lm.init(cfg, seed=serve_cfg.seed, device=device)
    else:
        params = tree.map_structure(lambda t: t.to(device), params)
    if draft_params is not None:
        draft_params = tree.map_structure(lambda t: t.to(device), draft_params)
    rec = _arm_trace(serve_cfg) if mesh.rank == 0 else None
    try:
        policy = (kernels.use_policy(args.kernel_policy) if args.kernel_policy
                  else contextlib.nullcontext())
        with policy:
            engine = PagedEngine(cfg, params, config=serve_cfg,
                                 sampler=get_sampler(serve_cfg.sampler),
                                 draft=_draft(args, serve_cfg, draft_params, device),
                                 device=device, mesh=mesh)
            if args.server:
                served = serve_trace(args, cfg, serve_cfg, engine)
            else:
                with serve_cfg.fault_plan() or contextlib.nullcontext():
                    done = engine.run(make_requests(cfg, n=args.requests, max_new=args.max_new,
                                                    shared_prefix=args.shared_prefix,
                                                    seed=serve_cfg.seed))
    except Exception as e:  # noqa: BLE001 — raised by the launcher, as on one device
        if mesh.rank != 0:
            return None
        traceback.print_exc()  # the rank's traceback; the exception crosses alone
        return e
    finally:
        if rec is not None:
            _finish_trace(rec, serve_cfg.trace)
    if mesh.rank != 0:
        return None
    return served if args.server else (done, engine.stats())


def run_server(args, cfg, serve_cfg, engine: PagedEngine) -> list[Request]:
    """``--server``: one seeded trace, two drivers.  ``loop`` is the async
    ServeLoop (metrics snapshot validated, and written to
    ``--metrics-json``); ``sync`` is the turn-by-turn oracle.  Both print
    the same ``req …`` lines."""
    return report_server(args, serve_cfg, serve_trace(args, cfg, serve_cfg, engine))


def serve_trace(args, cfg, serve_cfg, engine: PagedEngine):
    """Serve ``--server``'s seeded trace under the run's fault plan with
    ``--server-driver``: ``sync`` gives ``(finished requests, stats())``;
    ``loop`` the ServeLoop's ``(drained requests, validated snapshot,
    {rid: state} of the others)``, and None on a mesh rank other than 0,
    which follows rank 0's loop."""
    from repro_torch.serve import follow

    trace = LoadGen(seed=serve_cfg.seed, qps=args.qps, duration=args.duration,
                    vocab=cfg.vocab, max_new=args.max_new,
                    shared_prefix_len=args.shared_prefix, shared_frac=args.shared_frac).trace()
    if engine.rank == 0:
        print(f"# trace: {len(trace)} requests over {args.duration}s @ qps {args.qps} "
              f"(seed {serve_cfg.seed}, driver {args.server_driver})", file=sys.stderr)
    with serve_cfg.fault_plan() or contextlib.nullcontext():
        if args.server_driver == "sync":
            done = engine.run([Request(rid=a.rid, prompt=list(a.prompt), max_new=a.max_new)
                               for a in trace])
            return done, engine.stats()
        if engine.rank != 0:
            follow(engine)
            return None
        loop = ServeLoop(engine, config=serve_cfg, metrics=ServeMetrics())
        results = loop.run_trace(trace)
    snap = validate_snapshot(loop.snapshot())
    drained = [r.engine_req for r in results.values() if r.state is Lifecycle.DRAINED]
    bad = {r.rid: r.state.name for r in results.values() if r.state is not Lifecycle.DRAINED}
    return drained, snap, bad


def report_server(args, serve_cfg, served) -> list[Request]:
    """Print what :func:`serve_trace` served — the ``req …`` lines, then the
    stats (``sync``) or the snapshot (``loop``, also written to
    ``--metrics-json``) on stderr — and return the requests.  Without
    ``--chaos`` a loop run fails unless every request drained."""
    if args.server_driver == "sync":
        done, stats = served
        print_request_lines(done)
        print(f"# paged kv stats: {stats}", file=sys.stderr)
        return done
    drained, snap, bad = served
    print_request_lines(drained)
    print(f"# serve metrics: {json.dumps(snap, sort_keys=True)}", file=sys.stderr)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.metrics_json}", file=sys.stderr)
    if bad and serve_cfg.fault_plan() is None:
        # without injected faults every request must drain; a chaos run
        # may end with typed failures (reported above)
        raise SystemExit(f"requests did not drain: {bad}")
    return drained


def _arm_trace(serve_cfg):
    """Arm the global recorder when ``--trace PATH`` was given, before the
    engine is built, so every span of the run lands in the trace."""
    if not serve_cfg.trace:
        return None
    from repro_torch.obs import trace as obs_trace

    # the Recorder's default clock is time.monotonic, the clock ServeLoop
    # and the metrics read, so span endpoints share their timebase
    return obs_trace.start(meta={
        "tool": "launch.serve",
        "seed": serve_cfg.seed,
        "num_shards": serve_cfg.num_shards,
        "mcast_mode": serve_cfg.mcast_mode,
    })


def _finish_trace(rec, path: str) -> None:
    """Disarm, export the trace, and write the schema-validated report
    beside it (``PATH.report.json``).  The status line goes to stderr:
    stdout is the token-stream surface."""
    from repro_torch.obs import analyze as obs_analyze
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import trace as obs_trace

    obs_trace.stop()
    obs_export.write(rec, path)
    report = obs_analyze.analyze(obs_export.validate_trace(obs_export.to_chrome(rec)))
    report_path = path + ".report.json"
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"# wrote trace {path} ({len(rec)} events, {rec.n_dropped} dropped) + report "
          f"{report_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
