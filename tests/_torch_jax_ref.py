"""JAX-side references for the port's model and serving tests.

Run as a script in its own process (``jax_reference`` in
``_torch_util.py`` does this), with ``--xla_allow_excess_precision=false``
in ``XLA_FLAGS`` so that XLA keeps every bf16 rounding the JAX code
writes — the jitted steps otherwise skip some of them, and greedy
tokens follow those roundings.  The port rounds at exactly the places
the code says, so with the flag the two agree to float32 round-off.
Every kernel runs under ``backend=pallas`` (interpret mode on the CPU),
the numerics the port's kernels implement — except mode ``refserve``,
which serves on JAX's CPU default, the ``reference`` backend.  Modes
``serve``, ``refserve``, ``chaos``, ``loop`` and ``recurrent`` build many
engines or servers, and let them share their jitted steps
(:func:`_share_jits`).

    python tests/_torch_jax_ref.py \
        {model|serve|dense|quant|untied|int8serve|spec|refserve|chaos|loop|moe|moeserve|
         recurrent|families|famserve|encdec|train|trainloop|trace} OUT.npz
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import sys

import numpy as np

SEED = 0


def params_checksum(params) -> float:
    import jax

    return float(sum(np.abs(np.asarray(x, np.float32)).sum()
                     for x in jax.tree.leaves(jax.device_get(params))))


def model_case():
    """Token arrays for the logits references (shared with the test)."""
    rng = np.random.default_rng(3)
    return {
        "prompt_a": rng.integers(0, 512, size=20).astype(np.int32),
        "prompt_b": rng.integers(0, 512, size=11).astype(np.int32),
        "dense": rng.integers(0, 512, size=(2, 24)).astype(np.int32),
        "step1": rng.integers(0, 512, size=(2, 1)).astype(np.int32),
        "step5": rng.integers(0, 512, size=(2, 5)).astype(np.int32),
    }


def serve_requests(n=6, shared_prefix=24, max_new=8, seed=7):
    """(rid, prompt, max_new) triples, one numpy seed for both sides."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, 512, size=shared_prefix)]
    return [(i, prefix + [int(t) for t in rng.integers(0, 512, size=3 + i)], max_new)
            for i in range(n)]


#: the engine runs held against each other: name -> (request kwargs, engine kwargs)
SERVE_RUNS = {
    "shared_prefix": ({}, dict(max_batch=4, cache_len=64, page_size=8)),
    "chunked": ({}, dict(max_batch=4, cache_len=64, page_size=8, prefill_chunk=4)),
    # a pool too small for two full requests: decode page faults preempt
    "preempt": (dict(n=3, shared_prefix=0, max_new=10, seed=3),
                dict(max_batch=2, cache_len=64, page_size=4, num_pages=7, watermark=1)),
}

#: the paged-engine options that construct since the guard, fallback and
#: fault plans were ported, each run over ``serve_requests()`` on the
#: default ServeConfig (an option's ``chaos`` plan armed around the run)
SERVE_OPTION_RUNS = {
    "int8+kv_guard": dict(kv_dtype="int8", kv_guard=True),
    "kv_guard": dict(kv_guard=True),
    "kernel_fallback": dict(kernel_fallback=True),
    "chaos": dict(chaos=("pool.alloc",)),
}
#: stats() keys of the option runs held equal to JAX's
OPTION_STATS = ("prefix_hit_tokens", "preempted", "cow_copies", "kernel_fallbacks",
                "quarantined_pages", "degrade_requeues", "swap_dropped", "failed", "rejected")

#: the ServeLoop's seeded trace (``tests/test_server_loop.py``'s flagship)
#: and its engine
LOOP_TRACE = dict(seed=3, qps=30.0, duration=0.3, max_new=6, shared_prefix_len=24,
                  shared_frac=0.5)
LOOP_ENGINE = dict(max_batch=3, cache_len=128, page_size=16, num_pages=64)
#: the launcher's ``--server`` flags of the loop references (either driver)
SERVER_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--server", "--qps", "6", "--duration",
               "1.0", "--max-slots", "3", "--shared-prefix", "24", "--max-new", "8",
               "--seed", str(SEED)]

LAUNCH_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "6",
               "--max-new", "8", "--shared-prefix", "24", "--seed", str(SEED)]

#: kernel policies the dense ``Server`` is held to the JAX launcher under
DENSE_POLICIES = ("backend=pallas", "mcast", "unicast")


def dense_runs() -> dict[str, list[str]]:
    """The JAX launcher runs of the ``dense`` reference, by name: the
    dense server under every policy, and both KV backends on cold prompts
    and on the shared-prefix workload under ``backend=pallas``."""
    cold = [a for a in LAUNCH_ARGS if a not in ("--shared-prefix", "24")]
    runs = {f"dense {p}": [*LAUNCH_ARGS, "--kv", "dense", "--kernel-policy", p]
            for p in DENSE_POLICIES}
    runs["paged backend=pallas"] = [*LAUNCH_ARGS, "--kv", "paged",
                                    "--kernel-policy", "backend=pallas"]
    for kv in ("dense", "paged"):
        runs[f"cold {kv}"] = [*cold, "--kv", kv, "--kernel-policy", "backend=pallas"]
    return runs


#: the speculative pair: the reduced qwen1.5-1.8b target and its
#: registered draft, each initialised from SEED (as the launcher does)
TARGET, DRAFT = "qwen1.5-1.8b", "qwen1.5-0.5b"
SPEC_SHAPE = dict(max_slots=2, cache_len=64, page_size=8)
#: PagedEngine runs on the target (mode ``int8serve``): name -> (request
#: kwargs, ServeConfig kwargs over SPEC_SHAPE); "bf16" is the plain
#: reference the int8 streams are not held to
INT8_RUNS = {
    "bf16": (dict(n=4, max_new=12), {}),
    "int8": (dict(n=4, max_new=12), dict(kv_dtype="int8")),
    "int8_chunked": (dict(n=4, max_new=12), dict(kv_dtype="int8", prefill_chunk=4)),
    "int8_cold": (dict(n=4, shared_prefix=0, max_new=12), dict(kv_dtype="int8")),
    # a pool too small for two full requests: decode page faults swap
    # int8 pages and their scales out and back
    "int8_preempt": (dict(n=3, shared_prefix=0, max_new=10, seed=3),
                     dict(kv_dtype="int8", page_size=4, pages=7, watermark=1)),
}
#: speculative runs on the pair (mode ``spec``), the same shape; each
#: stream must equal the plain run on the same pools
SPEC_RUNS = {
    "spec_ngram": (dict(n=4, max_new=12), dict(spec_k=4, draft_model="ngram")),
    "spec_model": (dict(n=4, max_new=12), dict(spec_k=4, draft_model=DRAFT)),
    "int8_spec_ngram": (dict(n=4, max_new=12),
                        dict(kv_dtype="int8", prefill_chunk=4, spec_k=4, draft_model="ngram")),
    "int8_spec_model": (dict(n=4, max_new=12),
                        dict(kv_dtype="int8", spec_k=4, draft_model=DRAFT)),
}
#: the launcher flags of the slice's command, on the reduced pair
SPEC_LAUNCH_ARGS = ["--arch", TARGET, "--reduced", "--requests", "4", "--max-new", "10",
                    "--shared-prefix", "24", "--seed", str(SEED), "--kv", "paged",
                    "--kv-dtype", "int8", "--spec-k", "4", "--draft-model", "auto"]
#: stats() keys of the speculative engine held equal to JAX's
SPEC_STATS = ("prefix_hit_tokens", "preempted", "cow_copies", "spec_rounds", "spec_drafted",
              "spec_accepted", "spec_rollbacks", "spec_rollback_pages", "accept_rate")


def _model(out: dict) -> None:
    import jax.numpy as jnp

    from repro import kernels
    from repro.models import lm

    cfg, params = _setup()
    case = model_case()
    with kernels.use_policy("backend=pallas"):
        out["forward"] = np.asarray(lm.forward(params, cfg, jnp.asarray(case["dense"]))[0])
        out["prefill"] = np.asarray(
            lm.prefill(params, cfg, jnp.asarray(case["dense"]), logit_index=jnp.asarray([23, 9]))[0])
        # two sequences prefilled into their own pages, then one decode
        # token (the decode kernel) and a 5-token suffix (the prefill kernel)
        paged = lm.init_paged_cache(cfg, 16, 8)
        for name, table in (("prompt_a", [1, 2, 3, 0]), ("prompt_b", [4, 5, 0, 0])):
            toks = case[name]
            padded = np.zeros((1, 32), np.int32)
            padded[0, : len(toks)] = toks
            logits, dense = lm.prefill(params, cfg, jnp.asarray(padded),
                                       logit_index=len(toks) - 1)
            out[f"cold_{name}"] = np.asarray(logits)
            paged = lm.prefill_to_pages(dense, paged, jnp.asarray(table, jnp.int32), len(toks))
        table = jnp.asarray([[1, 2, 3, 6, 0, 0, 0, 0], [4, 5, 7, 0, 0, 0, 0, 0]], jnp.int32)
        logits, paged = lm.decode_step(params, cfg, paged, jnp.asarray(case["step1"]),
                                       jnp.asarray([20, 11], jnp.int32), block_table=table,
                                       lengths=jnp.asarray([21, 12], jnp.int32))
        out["decode1"] = np.asarray(logits)
        logits, paged = lm.decode_step(params, cfg, paged, jnp.asarray(case["step5"]),
                                       jnp.asarray([21, 12], jnp.int32), block_table=table,
                                       lengths=jnp.asarray([26, 17], jnp.int32))
        out["decode5"] = np.asarray(logits)
        out["k_pages_layer2"] = np.asarray(paged["stage0"]["b0"].k_pages[2], np.float32)


def _share_jits() -> None:
    """Let the JAX engines of this process share their jitted steps.  The
    engine jits fresh closures per instance, so a mode that builds dozens
    of engines would compile the same steps dozens of times.  A step is
    shared when its code, its closure's values and the jit options agree;
    the dispatch policy in force at the call is part of the key, since
    tracing reads it.  Patched after the package's imports, so only
    ``jax.jit`` calls made at run time (the engines') go through it."""
    import jax

    from repro import kernels

    real, memo = jax.jit, {}

    def jit(fn=None, **kw):
        if fn is None:
            return functools.partial(jit, **kw)
        try:
            key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ()),
                   repr(sorted(kw.items())))
            hash(key)
        except (AttributeError, TypeError, ValueError):
            return real(fn, **kw)

        def call(*args, **kwargs):
            full = key + (kernels.get_policy(),)
            if full not in memo:
                memo[full] = real(fn, **kw)
            return memo[full](*args, **kwargs)

        return call

    jax.jit = jit


def _serve(out: dict) -> None:
    from repro import kernels
    from repro.serve import PagedEngine, Request, ServeConfig

    cfg, params = _setup()
    streams = {}
    with kernels.use_policy("backend=pallas"):
        for name, (req_kw, eng_kw) in SERVE_RUNS.items():
            eng = PagedEngine(cfg, params, **eng_kw)
            done = eng.run([Request(rid=r, prompt=p, max_new=m)
                            for r, p, m in serve_requests(**req_kw)])
            eng.check()
            streams[name] = {"out": {str(r.rid): [int(t) for t in r.out] for r in done},
                             "stats": {k: eng.stats()[k] for k in
                                       ("prefix_hit_tokens", "preempted", "cow_copies")}}
        for name, opt in SERVE_OPTION_RUNS.items():
            conf = ServeConfig(**opt)
            eng = PagedEngine(cfg, params, config=conf)
            reqs = [Request(rid=r, prompt=p, max_new=m) for r, p, m in serve_requests()]
            plan = conf.fault_plan()
            with plan or contextlib.nullcontext():
                done = eng.run(reqs)
            eng.check()
            st = eng.stats()
            streams[f"option {name}"] = {
                "out": {str(r.rid): [int(t) for t in r.out] for r in done},
                "fired": [list(f) for f in plan.fired] if plan is not None else [],
                "stats": {k: st[k] for k in OPTION_STATS}}
    streams["launcher_stdout"] = _launch([*LAUNCH_ARGS, "--kv", "paged",
                                          "--kernel-policy", "backend=pallas"])
    out["serve_json"] = np.asarray(json.dumps(streams))


def _refserve(out: dict) -> None:
    """``SERVE_RUNS`` and an int8-pool run on JAX's CPU default, the
    reference backend (no policy set)."""
    from repro import kernels
    from repro.serve import PagedEngine, Request

    cfg, params = _setup()
    assert kernels.resolve("matmul", (4, 64, 64), "bfloat16").backend == "reference"
    streams = {}
    runs = dict(SERVE_RUNS, int8=({}, dict(max_batch=4, cache_len=64, page_size=8,
                                           kv_dtype="int8")))
    for name, (req_kw, eng_kw) in runs.items():
        eng = PagedEngine(cfg, params, **eng_kw)
        done = eng.run([Request(rid=r, prompt=p, max_new=m)
                        for r, p, m in serve_requests(**req_kw)])
        eng.check()
        streams[name] = {"out": {str(r.rid): [int(t) for t in r.out] for r in done},
                         "stats": {k: eng.stats()[k] for k in
                                   ("prefix_hit_tokens", "preempted", "cow_copies")}}
    out["refserve_json"] = np.asarray(json.dumps(streams))


def _chaos(out: dict) -> None:
    """Every case of ``_torch_chaos_cases.py`` on JAX's ``PagedEngine``."""
    from _torch_chaos_cases import cases, jax_package

    from repro import kernels

    pkg = jax_package()
    with kernels.use_policy("backend=pallas"):
        res = {name: fn(pkg) for name, fn in cases().items()}
    out["chaos_json"] = np.asarray(json.dumps(res))


def _loop(out: dict) -> None:
    """JAX's ``ServeLoop`` over ``LOOP_TRACE`` (realtime arrivals) and the
    synchronous ``PagedEngine.run`` over the same trace; the launcher's
    stdout under ``SERVER_ARGS`` with either driver."""
    from repro import kernels
    from repro.serve import LoadGen, PagedEngine, Request, ServeLoop

    cfg, params = _setup()
    trace = LoadGen(vocab=cfg.vocab, **LOOP_TRACE).trace()
    with kernels.use_policy("backend=pallas"):
        loop = ServeLoop(PagedEngine(cfg, params, **LOOP_ENGINE))
        results = loop.run_trace(trace)
        done = PagedEngine(cfg, params, **LOOP_ENGINE).run(
            [Request(rid=a.rid, prompt=list(a.prompt), max_new=a.max_new) for a in trace])
    out["loop_json"] = np.asarray(json.dumps({
        "loop": {str(r.rid): [int(t) for t in r.tokens] for r in results.values()},
        "states": sorted({r.state.name for r in results.values()}),
        "sync": {str(r.rid): [int(t) for t in r.out] for r in done},
        **{f"launcher_{driver}": _launch([*SERVER_ARGS, "--server-driver", driver,
                                          "--kernel-policy", "backend=pallas"])
           for driver in ("loop", "sync")}}))


def _quant(out: dict) -> None:
    """The reduced qwen1.5-1.8b on int8 pools: two cold prefills scattered
    (quantised) into pages, one decode token and a 5-token suffix (both K3
    under int8), and the pages of one layer afterwards."""
    import jax.numpy as jnp

    from repro import kernels
    from repro.models import lm

    cfg, params = _setup(TARGET)
    case = model_case()
    with kernels.use_policy("backend=pallas"):
        paged = lm.init_paged_cache(cfg, 16, 8, "int8")
        for name, table in (("prompt_a", [1, 2, 3, 0]), ("prompt_b", [4, 5, 0, 0])):
            toks = case[name]
            padded = np.zeros((1, 32), np.int32)
            padded[0, : len(toks)] = toks
            logits, dense = lm.prefill(params, cfg, jnp.asarray(padded),
                                       logit_index=len(toks) - 1)
            out[f"cold_{name}"] = np.asarray(logits)
            paged = lm.prefill_to_pages(dense, paged, jnp.asarray(table, jnp.int32), len(toks))
        layer = paged["stage0"]["b0"]
        for leaf in ("k_pages", "v_pages", "k_scale", "v_scale"):
            out[f"cold_{leaf}"] = np.asarray(getattr(layer, leaf), np.float32)
        table = jnp.asarray([[1, 2, 3, 6, 0, 0, 0, 0], [4, 5, 7, 0, 0, 0, 0, 0]], jnp.int32)
        logits, paged = lm.decode_step(params, cfg, paged, jnp.asarray(case["step1"]),
                                       jnp.asarray([20, 11], jnp.int32), block_table=table,
                                       lengths=jnp.asarray([21, 12], jnp.int32))
        out["decode1"] = np.asarray(logits)
        logits, paged = lm.decode_step(params, cfg, paged, jnp.asarray(case["step5"]),
                                       jnp.asarray([21, 12], jnp.int32), block_table=table,
                                       lengths=jnp.asarray([26, 17], jnp.int32))
        out["decode5"] = np.asarray(logits)
        layer = paged["stage0"]["b0"]
        out["k_pages_layer1"] = np.asarray(layer.k_pages[1], np.float32)
        out["k_scale_layer1"] = np.asarray(layer.k_scale[1], np.float32)


def untied_config(cfg):
    """The reduced qwen1.5-1.8b with its own output head, as the full
    config has (the reduced one ties its embeddings)."""
    import dataclasses

    return dataclasses.replace(cfg, tie_embeddings=False)


def _untied(out: dict) -> None:
    """Logits through the untied head (B = ``unembed.w``, (d, vocab))."""
    import jax
    import jax.numpy as jnp

    from repro import kernels
    from repro.configs import get_config
    from repro.models import lm

    cfg = untied_config(get_config(TARGET, reduced=True))
    params = lm.init(cfg, jax.random.PRNGKey(SEED))
    case = model_case()
    with kernels.use_policy("backend=pallas"):
        out["forward"] = np.asarray(lm.forward(params, cfg, jnp.asarray(case["dense"]))[0])
        out["prefill"] = np.asarray(
            lm.prefill(params, cfg, jnp.asarray(case["dense"]), logit_index=jnp.asarray([23, 9]))[0])
    out["params_checksum"] = np.asarray(params_checksum(params))


def _engine_runs(runs: dict) -> dict:
    """Each run's streams and ``SPEC_STATS`` on JAX's ``PagedEngine``."""
    from repro import kernels
    from repro.serve import PagedEngine, Request, ServeConfig

    cfg, params = _setup(TARGET)
    dcfg, dparams = _setup(DRAFT)
    streams = {}
    with kernels.use_policy("backend=pallas"):
        for name, (req_kw, eng_kw) in runs.items():
            conf = ServeConfig(**{**SPEC_SHAPE, **eng_kw})
            draft = (dcfg, dparams) if conf.draft_model == DRAFT else None
            eng = PagedEngine(cfg, params, config=conf, draft=draft)
            done = eng.run([Request(rid=r, prompt=p, max_new=m)
                            for r, p, m in serve_requests(**req_kw)])
            eng.check()
            streams[name] = {"out": {str(r.rid): [int(t) for t in r.out] for r in done},
                             "stats": {k: eng.stats()[k] for k in SPEC_STATS}}
    return streams


def _int8serve(out: dict) -> None:
    out["serve_json"] = np.asarray(json.dumps(_engine_runs(INT8_RUNS)))


def _spec(out: dict) -> None:
    streams = _engine_runs(SPEC_RUNS)
    streams["launcher_stdout"] = _launch(SPEC_LAUNCH_ARGS + ["--kernel-policy", "backend=pallas"])
    out["spec_json"] = np.asarray(json.dumps(streams))
    out["draft_checksum"] = np.asarray(params_checksum(_setup(DRAFT)[1]))


def _launch(args: list[str]) -> str:
    """stdout of one ``python -m repro.launch.serve ARGS`` run, in process."""
    from repro import kernels
    from repro.launch import serve as jax_serve

    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["repro.launch.serve", *args]
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            jax_serve.main()
    finally:
        sys.argv = argv
        kernels.set_policy(None)  # the launcher sets the global policy
    return buf.getvalue()


def _dense(out: dict) -> None:
    out["dense_json"] = np.asarray(json.dumps(
        {name: _launch(args) for name, args in dense_runs().items()}))


#: the MoE archs held against JAX at their reduced configs (mode ``moe``)
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
#: the dense-Server launcher runs on the reduced moonshot (mode
#: ``moeserve``): no shared prefix, so the prompts' lengths differ (4-11
#: tokens, five lengths) and a bucketed prefill would pad every one
MOE_LAUNCH_ARGS = ["--arch", "moonshot-v1-16b-a3b", "--reduced", "--requests", "6",
                   "--max-new", "8", "--seed", str(SEED), "--kv", "dense"]


def moe_case():
    """Token arrays for the MoE logits references (shared with the test)."""
    rng = np.random.default_rng(11)
    return {
        "dense": rng.integers(0, 512, size=(2, 24)).astype(np.int32),
        "prompt": rng.integers(0, 512, size=(2, 13)).astype(np.int32),
        "step1": rng.integers(0, 512, size=(2, 1)).astype(np.int32),
        "step3": rng.integers(0, 512, size=(2, 3)).astype(np.int32),
    }


def _moe(out: dict) -> None:
    """Per MoE arch: ``forward``'s logits and aux loss, a prefill's
    logits at given rows, then two decode steps (1 and 3 tokens) against
    the dense caches that prefill built."""
    import jax.numpy as jnp

    from repro import kernels
    from repro.models import lm

    case = moe_case()
    for arch in MOE_ARCHS:
        cfg, params = _setup(arch)
        with kernels.use_policy("backend=pallas"):
            logits, aux = lm.forward(params, cfg, jnp.asarray(case["dense"]))
            out[f"{arch}/forward"], out[f"{arch}/aux"] = np.asarray(logits), np.asarray(aux)
            logits, caches = lm.prefill(params, cfg, jnp.asarray(case["prompt"]), cache_slots=32,
                                        logit_index=jnp.asarray([12, 7]))
            out[f"{arch}/prefill"] = np.asarray(logits)
            logits, caches = lm.decode_step(params, cfg, caches, jnp.asarray(case["step1"]),
                                            jnp.int32(13))
            out[f"{arch}/decode1"] = np.asarray(logits)
            logits, caches = lm.decode_step(params, cfg, caches, jnp.asarray(case["step3"]),
                                            jnp.int32(14))
            out[f"{arch}/decode3"] = np.asarray(logits)
        out[f"{arch}/params_checksum"] = np.asarray(params_checksum(params))


def _moeserve(out: dict) -> None:
    """The JAX launcher's dense ``Server`` on the reduced moonshot under
    every ``DENSE_POLICIES`` entry, and the ``ValueError`` text that
    paged serving of an MoE arch raises (``lm.init_paged_cache``,
    ``PagedEngine``, ``--kv paged``)."""
    from repro.models import lm
    from repro.serve import PagedEngine

    runs = {p: _launch([*MOE_LAUNCH_ARGS, "--kernel-policy", p]) for p in DENSE_POLICIES}
    cfg, params = _setup("moonshot-v1-16b-a3b")
    errors = {}
    for name, call in (("init_paged_cache", lambda: lm.init_paged_cache(cfg, 8, 8)),
                       ("PagedEngine", lambda: PagedEngine(cfg, params)),
                       ("launcher", lambda: _launch([*MOE_LAUNCH_ARGS[:-1], "paged"]))):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    out["moeserve_json"] = np.asarray(json.dumps({"runs": runs, "errors": errors}))


#: the recurrent archs held against JAX at their reduced configs (mode
#: ``recurrent``)
RECURRENT_ARCHS = ("mamba2-780m", "recurrentgemma-2b")
#: the launcher flags that ask for paged serving (each refused for the
#: recurrent archs, JAX's error held)
PAGED_ASKS = {"kv-paged": ["--kv", "paged"], "server": ["--server"],
              "spec-k": ["--spec-k", "4"],
              "kv-paged-spec-k": ["--kv", "paged", "--spec-k", "4", "--draft-model", "ngram"]}


def recurrent_launch_args(arch: str) -> list[str]:
    """The dense-Server launcher run on a reduced recurrent arch: no shared
    prefix, so the prompts are 4-11 tokens (no bucketing for these archs)."""
    return ["--arch", arch, "--reduced", "--requests", "6", "--max-new", "8", "--seed",
            str(SEED), "--kv", "dense"]


def recurrent_case():
    """Token arrays for the recurrent logits references (shared with the test)."""
    rng = np.random.default_rng(13)
    return {
        "dense": rng.integers(0, 512, size=(2, 24)).astype(np.int32),
        "prompt": rng.integers(0, 512, size=(2, 13)).astype(np.int32),
        "steps": rng.integers(0, 512, size=(2, 8)).astype(np.int32),
        "long": rng.integers(0, 512, size=(1, 300)).astype(np.int32),
    }


def window16_config(cfg):
    """``cfg`` (either package's reduced recurrentgemma) with window-16
    local attention, so that rings wrap and prompts past 144 tokens take
    the banded path at reduced sizes."""
    import dataclasses

    stages = tuple((tuple(dataclasses.replace(bd, window=16) if bd.mixer == "attn" else bd
                          for bd in pattern), repeats) for pattern, repeats in cfg.stages)
    return dataclasses.replace(cfg, name=cfg.name + "-w16", stages=stages)


def window16_requests():
    """(rid, prompt, max_new) of the window-16 ``Server`` run: prompts of
    10-30 tokens and 12 new tokens, so every ring wraps while decoding."""
    rng = np.random.default_rng(21)
    return [(i, [int(x) for x in rng.integers(0, 512, size=n)], 12)
            for i, n in enumerate((10, 17, 30, 23, 12))]


def _recurrent(out: dict) -> None:
    """Per recurrent arch: ``forward``'s logits, a prefill's logits at given
    rows, then 8 one-token decode steps against the caches it built; the
    dense-Server launcher under every ``DENSE_POLICIES`` entry, and the
    launcher's refusals of paged serving (``PAGED_ASKS``).  Then the
    window-16 recurrentgemma (:func:`window16_config`): ``forward`` over
    300 tokens (the banded path), a 24-token prefill (the
    full path, a ring shorter than the prompt) and a 300-token one (banded),
    each followed by decode steps across the ring's wrap, one attention
    layer's ring after the 24-token prefill, and JAX's ``Server`` over
    :func:`window16_requests`."""
    import jax.numpy as jnp

    from repro import kernels
    from repro.launch.serve import Server
    from repro.models import lm
    from repro.serve import Request

    case = recurrent_case()
    runs, errors = {}, {}
    for arch in RECURRENT_ARCHS:
        cfg, params = _setup(arch)
        with kernels.use_policy("backend=pallas"):
            out[f"{arch}/forward"] = np.asarray(lm.forward(params, cfg,
                                                           jnp.asarray(case["dense"]))[0])
            logits, caches = lm.prefill(params, cfg, jnp.asarray(case["prompt"]), cache_slots=32,
                                        logit_index=jnp.asarray([12, 7]))
            out[f"{arch}/prefill"] = np.asarray(logits)
            for i in range(8):
                logits, caches = lm.decode_step(params, cfg, caches,
                                                jnp.asarray(case["steps"][:, i:i + 1]),
                                                jnp.int32(13 + i))
                out[f"{arch}/decode{i}"] = np.asarray(logits)
        out[f"{arch}/params_checksum"] = np.asarray(params_checksum(params))
        for policy in DENSE_POLICIES:
            runs[f"{arch} {policy}"] = _launch([*recurrent_launch_args(arch),
                                                "--kernel-policy", policy])
        for name, ask in PAGED_ASKS.items():
            errors[f"{arch} {name}"] = _launch_error(
                [a for a in recurrent_launch_args(arch) if a not in ("--kv", "dense")] + ask)

    cfg, params = _setup("recurrentgemma-2b")
    cfg = window16_config(cfg)
    with kernels.use_policy("backend=pallas"):
        out["w16/forward300"] = np.asarray(lm.forward(params, cfg, jnp.asarray(case["long"]))[0])
        for name, toks, rows, steps in (("24", case["dense"], [23, 23], 8),
                                        ("300", case["long"], [299], 4)):
            s = toks.shape[1]
            logits, caches = lm.prefill(params, cfg, jnp.asarray(toks), cache_slots=32,
                                        logit_index=jnp.asarray(rows))
            out[f"w16/prefill{name}"] = np.asarray(logits)
            if name == "24":
                ring = caches["stage0"]["b2"]
                out["w16/ring24_k"] = np.asarray(ring.k[0], np.float32)
                out["w16/ring24_pos"] = np.asarray(ring.pos[0])
            for i in range(steps):
                tok = case["steps"][: toks.shape[0], i:i + 1]
                logits, caches = lm.decode_step(params, cfg, caches, jnp.asarray(tok),
                                                jnp.int32(s + i))
                out[f"w16/decode{name}_{i}"] = np.asarray(logits)
        done = Server(cfg, params).run([Request(rid=r, prompt=p, max_new=m)
                                        for r, p, m in window16_requests()])
    runs["w16 server"] = {str(r.rid): [int(x) for x in r.out] for r in done}
    out["serve_json"] = np.asarray(json.dumps({"runs": runs, "errors": errors}))


#: the families of the last model slice, held against JAX at their reduced
#: configs through ``models/lm.py`` (whisper-medium as the JAX launcher
#: serves it; ``models/encdec.py`` runs it whole, mode ``encdec``)
FAMILY_ARCHS = ("gemma2-9b", "command-r-35b", "deepseek-7b", "pixtral-12b", "whisper-medium")
#: the archs the JAX launcher serves on ``--kv paged`` (gemma2's local
#: windows are refused)
PAGED_FAMILY_ARCHS = ("command-r-35b", "deepseek-7b", "pixtral-12b", "whisper-medium")
#: the family archs whose launcher runs each mode makes (two modes, so
#: that each test file's child stays short)
FAMILY_SERVED = {"families": ("pixtral-12b", "whisper-medium"),
                 "famserve": ("gemma2-9b", "command-r-35b", "deepseek-7b")}


def family_case():
    """Token arrays and front-end embeddings of the family logits
    references (shared with the test)."""
    import ml_dtypes

    rng = np.random.default_rng(17)
    return {
        "dense": rng.integers(0, 512, size=(2, 24)).astype(np.int32),
        "prompt": rng.integers(0, 512, size=(2, 13)).astype(np.int32),
        "steps": rng.integers(0, 512, size=(2, 4)).astype(np.int32),
        "patches": rng.standard_normal((2, 6, 32)).astype(ml_dtypes.bfloat16),
    }


def family_launch_args(arch: str) -> list[str]:
    """The launcher run of a reduced family arch: six requests after a
    24-token shared prefix (bucketed prefills, prefix hits on ``--kv
    paged``); gemma2 without the prefix, since JAX's banded attention
    raises on its window-16 layers for prompts of 33-48 tokens (its band,
    128 keys, outgrows the 64 padded keys: ROADMAP Queue 3 entry 21)."""
    prefix = [] if arch == "gemma2-9b" else ["--shared-prefix", "24"]
    return ["--arch", arch, "--reduced", "--requests", "6", "--max-new", "8", "--seed",
            str(SEED), *prefix]


def _family_logits(arch: str, params, cfg, case, out: dict, rows0=None) -> None:
    """``forward``, a prefill and 4 decode steps, each jitted once; with
    ``rows0`` (params) the decode steps run again on those params from the
    same prefill caches (``{arch}/decode_rows0_{i}``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm

    fe = jnp.asarray(case["patches"]) if cfg.frontend == "vision" else None
    n = 0 if fe is None else fe.shape[1]
    forward = jax.jit(lambda p, t, f: lm.forward(p, cfg, t, frontend_embeds=f)[0])
    prefill = jax.jit(lambda p, t, f, li: lm.prefill(p, cfg, t, frontend_embeds=f,
                                                     cache_slots=32, logit_index=li))
    step = jax.jit(lambda p, c, t, i: lm.decode_step(p, cfg, c, t, i))
    out[f"{arch}/forward"] = np.asarray(forward(params, jnp.asarray(case["dense"]), fe))
    logits, prefilled = prefill(params, jnp.asarray(case["prompt"]), fe,
                                jnp.asarray([n + 12, n + 7]))
    out[f"{arch}/prefill"] = np.asarray(logits)
    for name, p in (("decode", params), ("decode_rows0_", rows0)):
        caches = prefilled
        for i in range(case["steps"].shape[1] if p is not None else 0):
            logits, caches = step(p, caches, jnp.asarray(case["steps"][:, i:i + 1]),
                                  jnp.int32(n + 13 + i))
            out[f"{arch}/{name}{i}"] = np.asarray(logits)


def _family_launches(mode: str) -> dict[str, str]:
    """The JAX launcher on the family archs of ``FAMILY_SERVED[mode]``:
    the dense ``Server`` under every ``DENSE_POLICIES`` entry, and the
    paged engine (default policy) where JAX serves it."""
    runs = {}
    for arch in FAMILY_SERVED[mode]:
        for policy in DENSE_POLICIES:
            runs[f"{arch} dense {policy}"] = _launch([*family_launch_args(arch), "--kv", "dense",
                                                      "--kernel-policy", policy])
        if arch in PAGED_FAMILY_ARCHS:
            runs[f"{arch} paged"] = _launch([*family_launch_args(arch), "--kv", "paged",
                                             "--kernel-policy", "backend=pallas"])
    return runs


def _families(out: dict) -> None:
    """Per family arch: ``forward``'s logits (pixtral's over its projected
    patches and the tokens), a prefill's logits at given rows into 32-slot
    caches, then 4 one-token decode steps.  For whisper-medium also the
    same decode steps with every position row but row 0 zeroed
    (``decode_rows0_{i}``): a step adds row 0, whatever its index.  Then
    the launcher runs of ``FAMILY_SERVED["families"]``."""
    import jax.numpy as jnp

    from repro import kernels

    case = family_case()
    with kernels.use_policy("backend=pallas"):
        for arch in FAMILY_ARCHS:
            cfg, params = _setup(arch)
            rows0 = None
            if cfg.attn.learned_pos:
                table = params["pos"]["table"]
                rows0 = dict(params, pos={"table": jnp.zeros_like(table).at[0].set(table[0])})
            _family_logits(arch, params, cfg, case, out, rows0)
            out[f"{arch}/params_checksum"] = np.asarray(params_checksum(params))
    out["serve_json"] = np.asarray(json.dumps({"runs": _family_launches("families")}))


def _famserve(out: dict) -> None:
    """The launcher runs of ``FAMILY_SERVED["famserve"]``, and the errors
    of ``--kv paged`` under ``mcast`` / ``unicast`` (command-r) and for
    gemma2's windows."""
    errors = {}
    for policy in ("mcast", "unicast"):
        errors[f"command-r-35b paged {policy}"] = _launch_error(
            [*family_launch_args("command-r-35b"), "--kv", "paged", "--kernel-policy", policy])
    errors["gemma2-9b paged"] = _launch_error([*family_launch_args("gemma2-9b"), "--kv", "paged"])
    out["serve_json"] = np.asarray(json.dumps({"runs": _family_launches("famserve"),
                                               "errors": errors}))


#: whisper-medium through ``models/encdec.py`` (mode ``encdec``): the
#: reduced config's 24 frames of 32 dims, a 7-token prompt, ragged decode
ENCDEC_ARCH = "whisper-medium"


def encdec_case():
    """Frames and tokens of the encoder-decoder references (shared with the test)."""
    import ml_dtypes

    rng = np.random.default_rng(19)
    return {
        "frames": rng.standard_normal((2, 24, 32)).astype(ml_dtypes.bfloat16),
        "tokens": rng.integers(0, 512, size=(2, 7)).astype(np.int32),
        "steps": rng.integers(0, 512, size=(2, 4)).astype(np.int32),
        "index": np.asarray([7, 4], np.int32),  # ragged: row 1's prompt ends at 4
    }


def encdec_greedy(mod, params, cfg, case, n: int, asarray):
    """Greedy decoding of ``n`` tokens after the prompt, batch 2, one
    position per row (``case["index"]``): the stream the encdec tests
    hold equal across the two packages."""
    logits, caches = mod.prefill(params, cfg, asarray(case["tokens"]), asarray(case["frames"]),
                                 cache_slots=16)
    index = case["index"].copy()
    toks = [np.asarray(logits[:, -1]).argmax(-1).astype(np.int32)]
    for _ in range(n - 1):
        logits, caches = mod.decode_step(params, cfg, caches, asarray(toks[-1][:, None]),
                                         asarray(index))
        toks.append(np.asarray(logits[:, -1]).argmax(-1).astype(np.int32))
        index = index + 1
    return np.stack(toks, axis=1)


def flip_last_bit(a: np.ndarray) -> np.ndarray:
    """A bf16 array with the last bit of every element flipped (one ulp)."""
    return (np.asarray(a).view(np.uint16) ^ 1).view(a.dtype)


def _encdec(out: dict) -> None:
    """whisper-medium (reduced) through ``models/encdec.py``: ``encode``,
    ``forward`` and a prefill into 16-slot rings, each also on the frames
    with their last bit flipped (``*_flipped``: how far one ulp at the
    input moves JAX itself); the prefill's caches (``cache_*``), then 4
    decode steps from them at a ragged (batch,) index; an 8-token greedy
    stream."""
    import jax
    import jax.numpy as jnp

    from repro import kernels
    from repro.configs import get_config
    from repro.models import encdec

    cfg = get_config(ENCDEC_ARCH, reduced=True)
    params = encdec.init(cfg, jax.random.PRNGKey(SEED))
    case = encdec_case()
    tokens = jnp.asarray(case["tokens"])
    with kernels.use_policy("backend=pallas"):
        # the plain frames last: their prefill's caches feed the decode steps
        for tag, frames in (("_flipped", flip_last_bit(case["frames"])), ("", case["frames"])):
            frames = jnp.asarray(frames)
            out[f"encode{tag}"] = np.asarray(encdec.encode(params, cfg, frames), np.float32)
            out[f"forward{tag}"] = np.asarray(encdec.forward(params, cfg, tokens, frames)[0])
            logits, caches = encdec.prefill(params, cfg, tokens, frames, cache_slots=16)
            out[f"prefill{tag}"] = np.asarray(logits)
        for name in ("k", "v", "pos"):
            out[f"cache_self_{name}"] = np.asarray(getattr(caches["self"], name), np.float32)
        for name in ("k", "v"):
            out[f"cache_cross_{name}"] = np.asarray(getattr(caches["cross"], name), np.float32)
        for i in range(case["steps"].shape[1]):
            logits, caches = encdec.decode_step(params, cfg, caches,
                                                jnp.asarray(case["steps"][:, i:i + 1]),
                                                jnp.asarray(case["index"] + i))
            out[f"decode{i}"] = np.asarray(logits)
        out["greedy"] = encdec_greedy(encdec, params, cfg, case, 8, jnp.asarray)
    out["params_checksum"] = np.asarray(params_checksum(params))


#: the reduced archs whose loss and gradients the training tests hold, and
#: the ``loss_fn`` keywords each runs under (``loss_chunk`` 8 splits the
#: 24 positions of ``train_case`` into three chunks; qwen carries the
#: chunked and recomputed variants, the others the whole loss)
TRAIN_RUNS = {
    "qwen1.5-0.5b": {"whole": dict(loss_chunk=None), "chunked": dict(loss_chunk=8),
                     "remat": dict(loss_chunk=8, remat=True)},
    "moonshot-v1-16b-a3b": {"whole": dict(loss_chunk=None)},
    "mamba2-780m": {"whole": dict(loss_chunk=None)},
}


def train_case():
    """Tokens and next-token labels of the loss references (shared with the test)."""
    rng = np.random.default_rng(17)
    toks = rng.integers(0, 512, size=(2, 25)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict of arrays -> {"a/b/c": fp32 numpy array} (bf16 widens
    exactly)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _train(out: dict) -> None:
    """Per arch of ``TRAIN_RUNS``: ``jax.value_and_grad(lm.loss_fn)`` under
    ``backend=pallas`` (interpret mode) on ``train_case``, per variant; and
    the witness ``flip``: the ``whole`` variant with the last bit of every
    element of the layer-0 input (the bf16 embeddings) flipped, one ulp."""
    import jax
    import jax.numpy as jnp

    from repro import kernels
    from repro.models import lm

    case = {k: jnp.asarray(v) for k, v in train_case().items()}
    real_embed = lm._embed_inputs

    def flipped(*args, **kw):
        x = real_embed(*args, **kw)
        return jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(x, jnp.int16) ^ 1, jnp.bfloat16)

    for arch, runs in TRAIN_RUNS.items():
        cfg, params = _setup(arch)
        for name, kw in (*runs.items(), ("flip", runs["whole"])):
            def loss(p, kw=kw):
                return lm.loss_fn(p, cfg, case["tokens"], case["labels"], **kw)

            lm._embed_inputs = flipped if name == "flip" else real_embed
            with kernels.use_policy("backend=pallas"):
                value, grads = jax.jit(jax.value_and_grad(loss))(params)
            out[f"{arch}/{name}/loss"] = np.asarray(value)
            for path, g in flat_tree(jax.device_get(grads)).items():
                out[f"{arch}/{name}/grad/{path}"] = g
        lm._embed_inputs = real_embed
        out[f"{arch}/params_checksum"] = np.asarray(params_checksum(params))


#: the launcher runs of the loop references: the JAX launcher's flags
#: (without ``--ckpt-dir``), on its CPU default, the reference backend
TRAIN_LOOP_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "4", "--seq", "32",
                   "--steps", "12", "--ckpt-every", "4", "--log-every", "1",
                   "--seed", str(SEED)]
TRAIN_CRASH_AT = 9


def train_loop_runs(ckpt_dir) -> dict[str, list[str]]:
    """name -> the launcher's argv: a whole run, then in a directory of
    their own a run that crashes at ``TRAIN_CRASH_AT`` and its resume."""
    import os

    whole, crash = os.path.join(ckpt_dir, "whole"), os.path.join(ckpt_dir, "crash")
    return {"whole": [*TRAIN_LOOP_ARGS, "--ckpt-dir", whole],
            "crash": [*TRAIN_LOOP_ARGS, "--ckpt-dir", crash,
                      "--simulate-failure-at", str(TRAIN_CRASH_AT)],
            "resume": [*TRAIN_LOOP_ARGS, "--ckpt-dir", crash, "--resume"]}


def _train_launch(args: list[str]) -> tuple[dict | None, str, str]:
    """One JAX ``train_loop`` over ``args`` (parsed by the port's
    launcher, whose flags are the JAX launcher's and ``--device``) ->
    (its result or None, stdout, the exception it raised or "")."""
    from repro import kernels
    from repro.launch import train as jax_train
    from repro_torch.launch.train import parser

    stdout, res, err = io.StringIO(), None, ""
    try:
        with contextlib.redirect_stdout(stdout):
            res = jax_train.train_loop(parser().parse_args(args))
    except RuntimeError as e:
        err = str(e)
    finally:
        kernels.set_policy(None)
    return res, stdout.getvalue(), err


def _trainloop(out: dict) -> None:
    """The JAX launcher's runs of ``train_loop_runs``: each run's losses,
    stdout and error; and the witness ``flip``: the whole run with the
    last bit of every element of the layer-0 input flipped at every step
    (one bf16 ulp, the size of a rounding difference)."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from repro.models import lm

    with tempfile.TemporaryDirectory() as d:
        runs = train_loop_runs(d)
        runs["flip"] = [a if a != runs["whole"][-1] else a + "_flip" for a in runs["whole"]]
        real_embed = lm._embed_inputs
        for name, args in runs.items():
            if name == "flip":
                lm._embed_inputs = lambda *a, **kw: jax.lax.bitcast_convert_type(
                    jax.lax.bitcast_convert_type(real_embed(*a, **kw), jnp.int16) ^ 1,
                    jnp.bfloat16)
            res, text, err = _train_launch(args)
            lm._embed_inputs = real_embed
            out[f"{name}/losses"] = np.asarray(res["losses"] if res else [], np.float64)
            out[f"{name}/stdout"] = np.asarray(text)
            out[f"{name}/error"] = np.asarray(err)

def _launch_error(args: list[str]) -> list[str]:
    """How one ``python -m repro.launch.serve ARGS`` run fails, in process:
    [exception type, its message, the last line of stderr]."""
    from repro import kernels
    from repro.launch import serve as jax_serve

    err = io.StringIO()
    argv = sys.argv
    sys.argv = ["repro.launch.serve", *args]
    try:
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            jax_serve.main()
    except (ValueError, SystemExit) as e:
        return [type(e).__name__, str(e), (err.getvalue().strip().splitlines() or [""])[-1]]
    finally:
        sys.argv = argv
        kernels.set_policy(None)
    raise AssertionError(f"the JAX launcher served {args}")


#: the traced launcher run of mode ``trace``: the paged engine on the
#: shared-prefix workload under ``backend=pallas`` (the port adds
#: ``--device cpu`` and its own ``--trace PATH``)
TRACE_LAUNCH_ARGS = [*LAUNCH_ARGS, "--kv", "paged", "--kernel-policy", "backend=pallas"]


def _trace(out: dict) -> None:
    """The JAX launcher's stdout and its ``--trace`` report for
    ``TRACE_LAUNCH_ARGS``."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "jax_trace.json")
        stdout = _launch([*TRACE_LAUNCH_ARGS, "--trace", path])
        with open(path + ".report.json") as f:
            report = json.load(f)
    out["trace_json"] = np.asarray(json.dumps({"stdout": stdout, "report": report}))


def _setup(arch: str = "qwen1.5-0.5b"):
    import jax

    from repro.configs import get_config
    from repro.models import lm

    cfg = get_config(arch, reduced=True)
    return cfg, lm.init(cfg, jax.random.PRNGKey(SEED))


#: the architecture whose parameters each mode's checksum covers
MODE_ARCH = {"model": "qwen1.5-0.5b", "serve": "qwen1.5-0.5b", "dense": "qwen1.5-0.5b",
             "quant": TARGET, "int8serve": TARGET, "spec": TARGET,
             "refserve": "qwen1.5-0.5b", "chaos": "qwen1.5-0.5b", "loop": "qwen1.5-0.5b",
             "moeserve": "moonshot-v1-16b-a3b", "trainloop": "qwen1.5-0.5b",
             "trace": "qwen1.5-0.5b"}


def main(mode: str, path: str) -> None:
    out: dict = {}
    if mode in ("serve", "refserve", "chaos", "loop", "recurrent", "families", "famserve"):
        _share_jits()
    {"model": _model, "serve": _serve, "dense": _dense, "quant": _quant,
     "untied": _untied, "int8serve": _int8serve, "spec": _spec, "refserve": _refserve,
     "chaos": _chaos, "loop": _loop, "moe": _moe, "moeserve": _moeserve,
     "recurrent": _recurrent, "families": _families, "famserve": _famserve,
     "encdec": _encdec, "train": _train, "trainloop": _trainloop, "trace": _trace}[mode](out)
    if mode in MODE_ARCH:
        _, params = _setup(MODE_ARCH[mode])
        out["params_checksum"] = np.asarray(params_checksum(params))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
