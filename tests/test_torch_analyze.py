"""The port's trace analyzer (``repro_torch.obs.analyze``) against the
JAX package's (``repro.obs.analyze``).

* The same report surface: schema, dynamic key families, version, and
  the same report for the same events (the port's copy computes what
  JAX's does, tile keys and percentiles included).
* The schema gate and the CLI (the cases of ``tests/test_trace.py``).
* Parity of a traced run: the reduced qwen1.5-0.5b through both
  packages' paged launchers with ``--trace`` (the same seed, weights and
  flags, ``backend=pallas``; JAX in the child process of
  ``_torch_jax_ref.py``, mode ``trace``).  The two reports hold every
  host-side key equal — pool, prefix, speculation, requests, tokens,
  preemptions, faults, ``kernel_calls_*`` — and the same set of
  ``kernel_dispatch_<op>_<schedule>`` keys; timing keys are finite.  The
  dispatch counts differ by design: JAX records one span per kernel site
  per jit trace, the port one per call, so each port count is the calls
  the run made (stated below) and at least JAX's."""
import json
import math

import jax
import numpy as np
import pytest
import torch

from _torch_jax_ref import SEED, TRACE_LAUNCH_ARGS, params_checksum
from _torch_util import jax_reference
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.obs import analyze as jax_analyze
from repro_torch.configs import get_config
from repro_torch.obs import analyze as obs_analyze
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import PagedEngine, Request, ServeConfig
from repro_torch.weights import from_jax_params

#: report keys the host computes — every one equal between the packages
HOST_KEYS = (
    "prefix_pages_multicast", "prefix_pages_broadcast", "prefix_hit_tokens",
    "prefix_miss_tokens", "prefix_pages_inserted", "prefix_pages_evicted",
    "broadcast_chains", "broadcast_pages", "broadcast_payload_bytes", "broadcast_fabric_bytes",
    "broadcast_unicast_bytes", "broadcast_savings_frac",
    "pool_pages_allocated", "pool_pages_freed", "pool_pages_shared", "pool_cow_copies",
    "preemptions", "swap_ins", "swap_lost", "quarantined_pages", "sched_evictions",
    "admission_rejections", "faults_fired_total", "kernel_fallbacks",
    "spec_rounds", "spec_drafted", "spec_accepted", "spec_committed", "spec_rollback_pages",
    "spec_accept_rate", "requests_submitted", "requests_finished", "decode_ticks",
    "tokens_emitted", "kernel_calls_total", "trace_dropped",
)
TIMING_KEYS = ("decode_tick_p50_ms", "emit_lag_p50_ms", "queue_wait_p50_ms", "prefill_p50_ms",
               "ttft_decomposed_p50_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    assert obs_trace.active() is None, "a test leaked an armed recorder"
    yield
    obs_trace.stop()


def test_report_surface_is_the_reference_one():
    assert obs_analyze.REPORT_SCHEMA == jax_analyze.REPORT_SCHEMA
    assert obs_analyze.REPORT_DYNAMIC_PREFIXES == jax_analyze.REPORT_DYNAMIC_PREFIXES
    assert obs_analyze.REPORT_SCHEMA_VERSION == jax_analyze.REPORT_SCHEMA_VERSION
    assert obs_analyze.UNICAST_ROW_TILE == jax_analyze.UNICAST_ROW_TILE == 64
    assert obs_export.TRACE_SCHEMA_VERSION == 1


def _events(rng: np.random.Generator) -> list[dict]:
    """A seeded trace of every event kind the analyzer reads."""
    evs, t = [], 0.0

    def ev(name, ph, args=None, dur=None, **kw):
        nonlocal t
        t += float(rng.uniform(1.0, 500.0))
        e = {"name": name, "ph": ph, "ts": t, "pid": 1, "tid": 1, "cat": kw.pop("cat", "x"),
             **kw}
        if dur is not None:
            e["dur"] = dur
        if args is not None:
            e["args"] = args
        evs.append(e)

    for i in range(int(rng.integers(20, 60))):
        k = int(rng.integers(0, 12))
        m, kk, n = (int(x) for x in rng.integers(1, 4096, size=3))
        if k == 0:
            ev("engine.decode", "X", {"fallback": False}, float(rng.uniform(0, 1e4)),
               cat="kernel")
        elif k == 1:
            tile = {} if rng.random() < 0.5 else dict(
                gm=int(rng.choice([256, 512, 1024])), bm=128, bn=128, bk=64,
                design="wgmma")
            ev("dispatch.matmul", "X", {"op": "matmul", "schedule": "tiled", "backend": "pallas",
                                        "shape": [m, kk, n], "dtype": "bfloat16", **tile},
               float(rng.uniform(0, 100)), cat="kernel")
        elif k == 2:
            ev("dispatch.paged_attention", "X", {"op": "paged_attention", "schedule": "pallas",
                                                 "backend": "pallas", "shape": [4, 1, 16, 16],
                                                 "dtype": "bfloat16"}, 3.0, cat="kernel")
        elif k == 3:
            ev("prefix.match", "i", {"pages": int(rng.integers(0, 4)),
                                     "hit_tokens": int(rng.integers(0, 64)),
                                     "miss_tokens": int(rng.integers(0, 64))})
        elif k == 4:
            ev("pool.alloc", "i", {"n": int(rng.integers(1, 5)), "shard": 0})
        elif k == 5:
            ev("pool.release", "i", {"freed": int(rng.integers(0, 3))})
        elif k == 6:
            ev("spec.verify", "i", {"drafted": 4, "accepted": int(rng.integers(0, 5)),
                                    "committed": 3, "rollback_pages": int(rng.integers(0, 2))})
        elif k == 7:
            ev("request.queue_wait", "X", {"rid": i}, float(rng.uniform(0, 5e4)))
            ev("request.prefill", "X", {"rid": i}, float(rng.uniform(0, 5e4)))
        elif k == 8:
            ev("decode.tick", "X", {}, float(rng.uniform(0, 2e4)))
        elif k == 9:
            ev("token.emit", "i", {"lag_ms": float(rng.uniform(0, 30))})
        elif k == 10:
            ev("fault.pool.alloc", "i", {})
        else:
            ev("request", "b", id=str(i))
            ev("request", "e", id=str(i))
    return evs


@pytest.mark.parametrize("seed", range(4))
def test_same_events_give_the_reference_report(seed):
    trace = {"traceEvents": _events(np.random.default_rng(seed)), "metadata": {"n_dropped": 0}}
    assert obs_analyze.analyze(trace) == jax_analyze.analyze(trace)


def test_validate_report_rejects_malformed():
    report = obs_analyze.analyze({"traceEvents": []})
    obs_analyze.validate_report(report)
    with pytest.raises(ValueError, match="missing"):
        obs_analyze.validate_report({k: v for k, v in report.items() if k != "decode_ticks"})
    with pytest.raises(ValueError, match="unknown key"):
        obs_analyze.validate_report({**report, "surprise": 1})
    with pytest.raises(ValueError, match="wrong type"):
        obs_analyze.validate_report({**report, "decode_ticks": True})
    with pytest.raises(ValueError, match="not finite"):
        obs_analyze.validate_report({**report, "broadcast_savings_frac": float("nan")})


def test_analyze_cli_prints_table_and_writes_json(tmp_path, capsys):
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    from repro_torch.models import lm

    eng = PagedEngine(cfg, lm.init(cfg, seed=0, device="cpu"), device="cpu",
                      config=ServeConfig(max_slots=2, cache_len=64, page_size=8))
    rng = np.random.default_rng(7)
    prefix = list(rng.integers(0, cfg.vocab, size=16))
    with obs_trace.tracing() as rec:
        eng.run([Request(rid=i, prompt=prefix + list(rng.integers(0, cfg.vocab, size=3 + i)),
                         max_new=3) for i in range(3)])
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "r.json")
    obs_export.write(rec, tpath)
    assert obs_analyze.main([tpath, "--json", jpath]) == 0
    out = capsys.readouterr().out
    assert "prefix_pages_multicast" in out and "kernel_calls_total" in out
    assert json.load(open(jpath)) == obs_analyze.analyze(tpath)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(port report, port stdout, JAX report, JAX stdout) of the traced
    paged launcher run."""
    import contextlib
    import io

    from repro_torch.launch import serve as launcher

    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    ref = jax_reference("trace", tmp_path_factory.mktemp("jax_trace"))
    assert float(ref["params_checksum"]) == params_checksum(jparams)
    want = json.loads(str(ref["trace_json"]))
    path = str(tmp_path_factory.mktemp("port_trace") / "port.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        launcher.main([*TRACE_LAUNCH_ARGS, "--device", "cpu", "--trace", path],
                      params=from_jax_params(jax.device_get(jparams), device="cpu"))
    report = json.load(open(path + ".report.json"))
    obs_export.validate_trace(obs_export.load(path))
    return obs_analyze.validate_report(report), out.getvalue(), want["report"], want["stdout"]


def test_paged_launcher_report_matches_jax_on_host_keys(traced):
    got, got_out, want, want_out = traced
    assert got_out == want_out  # the same streams
    jax_analyze.validate_report(want)
    for key in HOST_KEYS:
        assert got[key] == want[key], key
    calls = sorted(k for k in want if k.startswith("kernel_calls_"))
    assert sorted(k for k in got if k.startswith("kernel_calls_")) == calls
    for key in calls:
        assert got[key] == want[key], key
    assert got["prefix_pages_multicast"] > 0 and got["kernel_calls_suffix_prefill"] > 0
    for key in TIMING_KEYS:
        assert math.isfinite(got[key]) and math.isfinite(want[key]), key


def test_paged_launcher_dispatch_keys_match_jax_and_count_calls(traced):
    got, _, want, _ = traced
    keys = lambda r: sorted(k for k in r if k.startswith("kernel_dispatch_")  # noqa: E731
                            and k != "kernel_dispatch_total")
    assert keys(got) == keys(want)
    # per call against per trace: every port count is at least JAX's ...
    for key in keys(got):
        assert got[key] >= want[key] > 0, key
    # ... and is the run's calls: each model step (cold prefill, suffix
    # prefill, decode) dispatches 7 projections a layer and the tied
    # logits, and the paged steps one attention call a layer; the cold
    # prefill's attention is memeff, not a kernel op
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    steps = got["kernel_calls_total"]
    assert got["kernel_dispatch_matmul_tiled"] == steps * (7 * cfg.n_layers + 1)
    assert got["kernel_dispatch_paged_attention_pallas"] == \
        got["kernel_calls_decode"] * cfg.n_layers
    assert got["kernel_dispatch_paged_attention_pallas_prefill"] == \
        got["kernel_calls_suffix_prefill"] * cfg.n_layers
    assert got["kernel_dispatch_total"] == sum(got[k] for k in keys(got))
    # the plain versions record no tile: one fetch of each call's whole B
    assert got["matmul_b_block_fetches"] == got["kernel_dispatch_matmul_tiled"]
