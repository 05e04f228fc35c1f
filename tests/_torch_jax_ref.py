"""JAX-side references for the port's model and serving tests.

Run as a script in its own process (``jax_reference`` in
``_torch_util.py`` does this), with ``--xla_allow_excess_precision=false``
in ``XLA_FLAGS`` so that XLA keeps every bf16 rounding the JAX code
writes — the jitted steps otherwise skip some of them, and greedy
tokens follow those roundings.  The port rounds at exactly the places
the code says, so with the flag the two agree to float32 round-off.
Every kernel runs under ``backend=pallas`` (interpret mode on the CPU),
the numerics the port's kernels implement.

    python tests/_torch_jax_ref.py {model|serve} OUT.npz
"""
from __future__ import annotations

import contextlib
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

LAUNCH_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "6",
               "--max-new", "8", "--shared-prefix", "24", "--seed", str(SEED)]


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


def _serve(out: dict) -> None:
    from repro import kernels
    from repro.launch import serve as jax_serve
    from repro.serve import PagedEngine, Request

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
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["repro.launch.serve", *LAUNCH_ARGS, "--kv", "paged",
                "--kernel-policy", "backend=pallas"]
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            jax_serve.main()
    finally:
        sys.argv = argv
        kernels.set_policy(None)
    streams["launcher_stdout"] = buf.getvalue()
    out["serve_json"] = np.asarray(json.dumps(streams))


def _setup():
    import jax

    from repro.configs import get_config
    from repro.models import lm

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    return cfg, lm.init(cfg, jax.random.PRNGKey(SEED))


def main(mode: str, path: str) -> None:
    out: dict = {}
    {"model": _model, "serve": _serve}[mode](out)
    _, params = _setup()
    out["params_checksum"] = np.asarray(params_checksum(params))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
