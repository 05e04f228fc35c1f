"""The port's async serve loop (``serve/server.py``), metrics
(``serve/metrics.py``) and load generator (``serve/loadgen.py``): the
cases of ``tests/test_server_loop.py`` on the port's ``ServeLoop`` over
its ``PagedEngine`` (``device="cpu"``, parameters converted from the JAX
package's) — streaming lifecycle, token parity with the synchronous
turn-by-turn driver, FIFO admission fairness under pressure, the metrics
schema, the seeded Poisson load generator and the engine's flat
stats-delta hook — plus the port against the JAX package itself: the
load generator's traces equal JAX's bit for bit, the snapshot schema is
JAX's, and the port's ``ServeLoop`` streams for a seeded trace equal JAX's
``ServeLoop`` streams for the same trace (``_torch_jax_ref.py loop``)."""
import contextlib
import dataclasses
import io
import json
import time

import jax
import numpy as np
import pytest
import torch

from _torch_jax_ref import LOOP_ENGINE, LOOP_TRACE, SEED, SERVER_ARGS, params_checksum
from _torch_util import jax_reference
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.serve import loadgen as jax_loadgen
from repro.serve import metrics as jax_metrics
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch import kernels
from repro_torch.serve import (
    SNAPSHOT_SCHEMA,
    Fault,
    FaultPlan,
    Lifecycle,
    LoadGen,
    PagedEngine,
    Request,
    ServeLoop,
    StreamingHistogram,
    replay,
    validate_snapshot,
)
from repro_torch.serve import metrics as torch_metrics
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Engine steps are many tiny ops: one torch thread, so the suite's
    other workers are not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, from_jax_params(jax.device_get(jparams), device="cpu")


def _mk_engine(cfg, params, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("cache_len", 128)
    kw.setdefault("page_size", 16)
    return PagedEngine(cfg, params, device="cpu", **kw)


def _mk_trace(cfg, *, seed=3, qps=30.0, duration=0.3, max_new=6,
              shared_prefix_len=24, shared_frac=0.5):
    return LoadGen(
        seed=seed, qps=qps, duration=duration, vocab=cfg.vocab,
        max_new=max_new, shared_prefix_len=shared_prefix_len,
        shared_frac=shared_frac,
    ).trace()


# ---------------------------------------------------------------------------
# the flagship contract: async loop == synchronous turn-by-turn driver
# ---------------------------------------------------------------------------

def test_loop_matches_sync_driver(small):
    cfg, params = small
    trace = _mk_trace(cfg)
    assert len(trace) >= 3  # seeded: the workload actually multiplexes

    loop = ServeLoop(_mk_engine(cfg, params, num_pages=64))
    results = loop.run_trace(trace)  # realtime Poisson arrivals
    assert {r.state for r in results.values()} == {Lifecycle.DRAINED}

    sync_eng = _mk_engine(cfg, params, num_pages=64)
    done = sync_eng.run([
        Request(rid=a.rid, prompt=list(a.prompt), max_new=a.max_new)
        for a in trace
    ])
    sync_out = {r.rid: r.out for r in done}
    loop_out = {r.rid: r.tokens for r in results.values()}
    assert loop_out == sync_out  # bitwise: same admissions, same math

    snap = validate_snapshot(loop.snapshot())
    assert snap["requests_drained"] == len(trace)
    assert snap["tokens_out"] == sum(a.max_new for a in trace)
    # continuous batching actually happened: >1 request decoding at once,
    # and at least one prefill landed while other requests were decoding
    assert snap["occupancy_max"] > 1
    assert snap["prefills_mid_decode"] >= 1
    assert snap["sustained_tok_s"] > 0
    loop.engine.check()
    sync_eng.check()


def test_streaming_tokens_and_result(small):
    cfg, params = small
    loop = ServeLoop(_mk_engine(cfg, params))
    rng = np.random.default_rng(0)
    sreq = loop.submit(list(rng.integers(0, cfg.vocab, size=6)), max_new=5)
    streamed = list(sreq.stream)  # blocks until the stream closes
    assert sreq.state is Lifecycle.DRAINED
    assert streamed == sreq.result() == sreq.tokens
    assert len(streamed) == 5
    loop.close()
    loop.engine.check()


def test_detokenize_accumulates_text(small):
    cfg, params = small
    loop = ServeLoop(_mk_engine(cfg, params), detokenize=lambda t: f"<{t}>")
    sreq = loop.submit([3, 1, 4, 1, 5], max_new=3)
    toks = sreq.result(timeout=60)
    loop.close()
    assert sreq.text == "".join(f"<{t}>" for t in toks)


# ---------------------------------------------------------------------------
# lifecycle + typed admission backpressure
# ---------------------------------------------------------------------------

def test_submit_rejections_are_typed(small):
    cfg, params = small
    eng = _mk_engine(cfg, params)  # cache_len=128
    loop = ServeLoop(eng, queue_cap=0)
    too_long = loop.submit(list(range(100)), max_new=60)
    assert too_long.state is Lifecycle.REJECTED
    assert too_long.error == "too-long"
    assert too_long.result() == []  # stream closed, no tokens

    # queue_cap=0: a servable request still bounces with a typed reason
    bounced = loop.submit([1, 2, 3], max_new=2)
    assert bounced.state is Lifecycle.REJECTED
    assert bounced.error == "queue-full"
    assert bounced.result() == []  # also waits out the async emit worker

    snap = validate_snapshot(loop.snapshot())
    assert snap["rejected_too-long"] == 1
    assert snap["rejected_queue-full"] == 1
    assert snap["requests_rejected"] == 2
    loop.close()
    with pytest.raises(RuntimeError):
        loop.submit([1], max_new=1)


def test_too_large_for_pool_rejected(small):
    cfg, params = small
    eng = _mk_engine(cfg, params, num_pages=3)  # 2 usable pages
    loop = ServeLoop(eng)
    sreq = loop.submit(list(range(40)), max_new=20)  # needs 4 pages ever
    assert sreq.state is Lifecycle.REJECTED
    assert sreq.error == "too-large"
    loop.close()


def test_unservable_head_fails_typed_not_hangs(small):
    cfg, params = small
    # pool technically large enough to pass the never-fits check, but
    # the watermark makes the demand unservable with an idle engine:
    # the loop must fail the request with a typed error, not spin
    eng = _mk_engine(cfg, params, num_pages=5, watermark=3)
    loop = ServeLoop(eng)
    sreq = loop.submit(list(range(30)), max_new=16)  # 3 pages + wm 3 > 4
    sreq.stream.closed.wait(timeout=60)
    assert sreq.state is Lifecycle.FAILED
    assert "unservable" in sreq.error
    loop.close()
    eng.check()


# ---------------------------------------------------------------------------
# FIFO fairness: a large queue head is never starved by later arrivals
# ---------------------------------------------------------------------------

def test_large_head_not_starved_by_small_arrivals(small):
    cfg, params = small
    # 6 usable pages, watermark 2.  Two runners (1 page each, growing)
    # occupy slots; the big request (4 pages) cannot pass the watermark
    # until both runners drain, while later 1-page requests could.
    eng = _mk_engine(cfg, params, num_pages=7, watermark=2)
    loop = ServeLoop(eng)
    rng = np.random.default_rng(1)
    runners = [
        loop.submit(list(rng.integers(0, cfg.vocab, size=4)), max_new=20)
        for _ in range(2)
    ]
    deadline = time.monotonic() + 60
    while not all(r.state is Lifecycle.DECODING for r in runners):
        assert time.monotonic() < deadline, "runners never admitted"
        time.sleep(0.002)
    big = loop.submit(list(rng.integers(0, cfg.vocab, size=60)), max_new=3)
    smalls = [
        loop.submit(list(rng.integers(0, cfg.vocab, size=4)), max_new=2)
        for _ in range(3)
    ]
    loop.close(drain=True)
    for r in runners + [big] + smalls:
        assert r.state is Lifecycle.DRAINED, (r.rid, r.state, r.error)
    # FIFO + retry_after_pages backoff: the big head was admitted before
    # every smaller arrival queued behind it
    tl = loop.metrics.timelines
    assert all(tl[big.rid].admitted <= tl[s.rid].admitted for s in smalls)
    # and the rejection taxonomy shows the head actually hit backpressure
    snap = validate_snapshot(loop.snapshot())
    assert any(k.startswith("rejected_") and v > 0
               for k, v in snap.items() if k != "rejected_too-long")
    eng.check()


def test_pressure_with_preemption_drains_clean(small):
    cfg, params = small
    # pool sized so concurrent decode growth forces page faults and
    # preemption under the loop (not just the sync driver)
    eng = _mk_engine(cfg, params, num_pages=9, watermark=1)
    loop = ServeLoop(eng)
    trace = _mk_trace(cfg, seed=11, qps=50, duration=0.2, max_new=24,
                      shared_prefix_len=0)
    results = loop.run_trace(trace, realtime=False)
    assert {r.state for r in results.values()} == {Lifecycle.DRAINED}
    for r in results.values():
        assert len(r.tokens) == r.engine_req.max_new
    eng.check()  # no page leaked through preempt/requeue under the loop


# ---------------------------------------------------------------------------
# shutdown
# ---------------------------------------------------------------------------

def test_abort_shutdown_fails_live_work_cleanly(small):
    cfg, params = small
    eng = _mk_engine(cfg, params)
    loop = ServeLoop(eng)
    rng = np.random.default_rng(2)
    live = loop.submit(list(rng.integers(0, cfg.vocab, size=4)), max_new=100)
    queued = [loop.submit(list(rng.integers(0, cfg.vocab, size=4)),
                          max_new=100) for _ in range(4)]
    deadline = time.monotonic() + 60
    while live.state is not Lifecycle.DECODING:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    loop.close(drain=False)
    assert live.state is Lifecycle.FAILED and live.error == "shutdown"
    # the queued tail behind the occupied slots was failed too, streams closed
    assert all(q.state in (Lifecycle.FAILED, Lifecycle.DRAINED) for q in queued)
    assert all(q.stream.closed.is_set() for q in queued)
    eng.check()  # aborted slots released their pages


# ---------------------------------------------------------------------------
# the engine driver: one command order, replayable; a worker that raises
# ---------------------------------------------------------------------------

def test_loop_command_log_replays_on_a_fresh_engine(small):
    """Every engine call of the loop goes through its driver: the command
    log, replayed on a fresh engine, makes the same calls — the same flat
    stats, tokens and pages — also with the interpreter switching threads
    every 10 µs, on ``test_pressure_with_preemption_drains_clean``'s small
    pool."""
    import sys

    cfg, params = small
    trace = _mk_trace(cfg, seed=11, qps=50, duration=0.2, max_new=24, shared_prefix_len=0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng = _mk_engine(cfg, params, num_pages=9, watermark=1)
        loop = ServeLoop(eng)
        results = loop.run_trace(trace, realtime=False)
    finally:
        sys.setswitchinterval(interval)
    assert {r.state for r in results.values()} == {Lifecycle.DRAINED}
    assert [c[0] for c in loop.driver.log].count("tick") == validate_snapshot(
        loop.snapshot())["decode_ticks"]
    again = _mk_engine(cfg, params, num_pages=9, watermark=1)
    driver = replay(again, loop.driver.log)
    assert again.flat_stats() == eng.flat_stats()
    assert {rid: r.out for rid, r in driver.requests.items()} == \
        {rid: r.tokens for rid, r in results.items()}
    assert torch.equal(again._pack(list(range(1, again.pool.num_pages))),
                       eng._pack(list(range(1, eng.pool.num_pages))))
    again.check()


def test_worker_error_fails_live_requests_and_close_raises_it(small):
    """A decode tick that raises stops the loop: the prefill worker
    returns, every request not yet terminal fails with the error, a later
    submit is refused, and ``close()`` raises the error at once (not after
    its join timeout)."""
    cfg, params = small
    eng = _mk_engine(cfg, params)
    step, calls = eng.step, []

    def failing():
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("planted tick failure")
        return step()

    eng.step = failing
    loop = ServeLoop(eng)
    sreqs = [loop.submit([5, 9, 2, 7 + i], max_new=20) for i in range(4)]
    for s in sreqs:
        s.stream.closed.wait(timeout=60)
    assert all(s.state is Lifecycle.FAILED and "planted tick failure" in s.error
               for s in sreqs)
    with pytest.raises(RuntimeError, match="a worker raised"):
        loop.submit([1, 2, 3], max_new=2)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="planted tick failure"):
        loop.close(timeout=30)
    assert time.monotonic() - t0 < 10
    assert not any(t.is_alive() for t in loop._threads)


# ---------------------------------------------------------------------------
# warmup: cached per-bucket prefill executables
# ---------------------------------------------------------------------------

def test_warmup_compiles_each_bucket_once(small):
    cfg, params = small
    eng = _mk_engine(cfg, params)
    loop = ServeLoop(eng)
    n1 = loop.warmup([4, 7], suffix_lens=[4])  # one cold bucket + decode + suffix
    assert n1 == 3  # 4 and 7 share the 16-bucket: one cold, one suffix, one decode step
    assert loop.warmup([10], suffix_lens=[9]) == 0  # all warm already
    assert loop.warmup([20]) == 1  # new 32-bucket
    assert validate_snapshot(loop.snapshot())["bucket_compiles"] == 4
    # warmup consumed no pool pages and left the engine fully serviceable
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    sreq = loop.submit([5, 9, 2, 7], max_new=3)
    assert sreq.result(timeout=60) and sreq.state is Lifecycle.DRAINED
    loop.close()
    eng.check()


# ---------------------------------------------------------------------------
# metrics: histograms + schema
# ---------------------------------------------------------------------------

def test_streaming_histogram_percentiles():
    h = StreamingHistogram()
    assert h.percentile(50) == 0.0  # empty
    for ms in [1, 2, 3, 4, 5, 6, 7, 8, 9, 100]:
        h.record(ms / 1e3)
    assert h.count == 10 and h.min == 1e-3 and h.max == 0.1
    # geometric buckets: ~10% relative resolution is the contract
    assert h.percentile(50) == pytest.approx(5.5e-3, rel=0.15)
    assert h.percentile(99) == pytest.approx(0.1, rel=0.15)
    assert h.percentile(0) == pytest.approx(1e-3, rel=0.15)
    assert h.mean == pytest.approx(14.5e-3)
    h2 = StreamingHistogram()
    h2.record(0.042)
    assert h2.percentile(50) == 0.042  # clamped to the observed extremes


def test_snapshot_schema_catches_violations(small):
    cfg, params = small
    loop = ServeLoop(_mk_engine(cfg, params))
    loop.close()
    snap = validate_snapshot(loop.snapshot())
    # engine counters ride along flat (no nesting anywhere)
    assert "engine_pool_allocated" in snap
    assert not any(isinstance(v, dict) for v in snap.values())

    for mutate, match in [
        (lambda s: s.pop("ttft_p50_ms"), "missing required key"),
        (lambda s: s.update(ttft_p50_ms="fast"), "has type str"),
        (lambda s: s.update(surprise=1), "unknown key"),
        (lambda s: s.update({"rejected_x": 1.5}), "has type float"),
    ]:
        bad = dict(snap)
        mutate(bad)
        with pytest.raises(ValueError, match=match):
            validate_snapshot(bad)


def test_stats_delta_is_flat_and_windowed(small):
    cfg, params = small
    eng = _mk_engine(cfg, params)
    reqs = [Request(rid=i, prompt=[7, 3, 9, i], max_new=3) for i in range(2)]
    eng.run(reqs)
    d1 = eng.stats_delta()
    assert d1["pool_allocated"] > 0 and d1["preempted"] == 0
    assert not any(isinstance(v, dict) for v in d1.values())
    # second window with no activity: counters zero, gauges current
    d2 = eng.stats_delta()
    assert d2["pool_allocated"] == 0 and d2["pool_freed"] == 0
    assert d2["free_pages"] == eng.pool.free_pages
    assert d2["prefix_pages"] == len(eng.prefix)
    # a third window sees exactly the new activity
    eng.run([Request(rid=9, prompt=[1, 2, 3], max_new=2)])
    d3 = eng.stats_delta()
    assert d3["pool_allocated"] == eng.sched.pages_for(3 + 1)


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

def test_loadgen_deterministic_and_shaped():
    mk = lambda seed: LoadGen(seed=seed, qps=100, duration=1.0, vocab=512,  # noqa: E731
                              prompt_len=(4, 12), max_new=(2, 8),
                              shared_prefix_len=16, shared_frac=0.5)
    t1, t2, t3 = mk(7).trace(), mk(7).trace(), mk(8).trace()
    assert t1 == t2  # bit-reproducible from the seed
    assert t1 != t3
    assert [a.t for a in t1] == sorted(a.t for a in t1)
    assert all(a.t < 1.0 for a in t1)
    assert 50 <= len(t1) <= 160  # Poisson around qps*duration=100
    shared = [a for a in t1 if a.shared]
    assert 0 < len(shared) < len(t1)
    prefix = mk(7).prefix
    assert all(a.prompt[:16] == prefix for a in shared)
    assert all(4 <= len(a.prompt) - (16 if a.shared else 0) <= 12 for a in t1)
    assert all(2 <= a.max_new <= 8 for a in t1)
    assert [a.rid for a in t1] == list(range(len(t1)))


def test_loadgen_empty_draw_still_yields_one_request():
    gen = LoadGen(seed=0, qps=1e-6, duration=1e-3, vocab=64)
    trace = gen.trace()
    assert len(trace) == 1 and trace[0].t == 0.0


def test_chaos_cli_spec_parsing():
    from repro_torch.serve.config import parse_chaos
    faults = parse_chaos(["swap.drop:0.25", "pool.alloc"])
    assert [(f.site, f.prob) for f in faults] == [
        ("swap.drop", 0.25), ("pool.alloc", 0.05)]
    with pytest.raises(ValueError):
        parse_chaos(["not.a.site:0.5"])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_loadgen_traces_equal_jax_bit_for_bit():
    kws = [dict(seed=7, qps=100, duration=1.0, vocab=512, prompt_len=(4, 12), max_new=(2, 8),
                shared_prefix_len=16, shared_frac=0.5),
           dict(seed=0, qps=1.5, duration=6.0, vocab=151936, prompt_len=(8, 28),
                max_new=(24, 32), shared_prefix_len=32, shared_frac=0.5),
           dict(seed=0, qps=1e-6, duration=1e-3, vocab=64),
           dict(vocab=512, **LOOP_TRACE)]
    for kw in kws:
        got, want = LoadGen(**kw), jax_loadgen.LoadGen(**kw)
        assert got.prefix == want.prefix
        assert [dataclasses.astuple(a) for a in got.trace()] == \
            [dataclasses.astuple(a) for a in want.trace()]


def test_snapshot_schema_is_jaxs():
    assert SNAPSHOT_SCHEMA == jax_metrics.SNAPSHOT_SCHEMA
    assert torch_metrics.SNAPSHOT_DYNAMIC_PREFIXES == jax_metrics.SNAPSHOT_DYNAMIC_PREFIXES
    h, hj = StreamingHistogram(), jax_metrics.StreamingHistogram()
    for x in np.random.default_rng(0).exponential(0.02, size=500):
        h.record(float(x))
        hj.record(float(x))
    assert [h.percentile(p) for p in (0, 50, 90, 99, 100)] == \
        [hj.percentile(p) for p in (0, 50, 90, 99, 100)]


@pytest.fixture(scope="module")
def loop_ref(tmp_path_factory, small):
    out = jax_reference("loop", tmp_path_factory.mktemp("jax_loop"))
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    assert float(out["params_checksum"]) == params_checksum(jparams)
    return json.loads(str(out["loop_json"]))


def test_loop_streams_equal_jax_serve_loop(small, loop_ref):
    """The port's ServeLoop and JAX's over the same seeded trace (real-time
    arrivals on both sides, so the admission interleavings differ): the
    same per-request streams, which also equal both sync drivers'."""
    cfg, params = small
    trace = LoadGen(vocab=cfg.vocab, **LOOP_TRACE).trace()
    loop = ServeLoop(_mk_engine(cfg, params, **LOOP_ENGINE))
    results = loop.run_trace(trace)
    assert {r.state for r in results.values()} == {Lifecycle.DRAINED}
    assert loop_ref["states"] == ["DRAINED"]
    got = {str(r.rid): r.tokens for r in results.values()}
    assert got == loop_ref["loop"] == loop_ref["sync"]
    validate_snapshot(loop.snapshot())
    loop.engine.check()


@pytest.mark.parametrize("driver", ["loop", "sync"])
def test_launcher_server_prints_jax_launchers_lines(small, loop_ref, driver):
    """``--server`` with either driver prints the ``req …`` lines of the
    JAX launcher's ``--server`` run on the same weights and flags — the
    two drivers agree in both packages."""
    _, params = small
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        launcher.main([*SERVER_ARGS, "--server-driver", driver, "--device", "cpu"],
                      params=params)
    lines = out.getvalue().splitlines()
    assert [ln for ln in lines if ln.startswith("req ")]
    assert lines == loop_ref["launcher_loop"].splitlines() == \
        loop_ref["launcher_sync"].splitlines()
    if driver == "loop":
        snap = json.loads(err.getvalue().split("# serve metrics: ", 1)[1].splitlines()[0])
        validate_snapshot(snap)


def test_loop_under_a_fault_plan_counts_what_fired(small):
    """The loop over a guarded engine under an armed plan (its admission
    backpressure reads the plan): every request drains, and the snapshot
    carries the fallbacks, one per kernel fault, and the fired sites."""
    cfg, params = small
    kernels.reset_fallback_stats()
    eng = _mk_engine(cfg, params, num_pages=64, kv_guard=True, kernel_fallback=True)
    loop = ServeLoop(eng)
    with FaultPlan([Fault("kernel.raise", at=3), Fault("kernel.nan", at=6),
                    Fault("pool.alloc", at=1)]) as plan:
        results = loop.run_trace(_mk_trace(cfg), realtime=False)
        snap = validate_snapshot(loop.snapshot())
    assert {r.state for r in results.values()} == {Lifecycle.DRAINED}
    assert sorted(plan.fired) == [("kernel.nan", 6), ("kernel.raise", 3), ("pool.alloc", 1)]
    assert snap["kernel_fallbacks"] == snap["engine_kernel_fallbacks"] == 2
    assert snap["fault_fired_kernel.raise"] == snap["fault_fired_kernel.nan"] == 1
    assert snap["fault_fired_pool.alloc"] == 1
    eng.check()
