"""The port's tracing layer: the cases of ``tests/test_trace.py`` on the
port's recorder (``repro_torch.obs.trace``), export
(``repro_torch.obs.export``) and engine / loop instrumentation —
recorder semantics (ring buffer, event forms, thread metadata, counter
order, arming), the export round trip and schema gate, the disabled path
(no events, no allocations, identical tokens), span nesting and the
analyzer's exact cross-checks against the live engine, pool and prefix
counters, and the loop's TTFT decomposition against its metrics — plus
what the port adds: the dispatch records (one ``dispatch.<op>`` span
per call, the CUDA design's tile where a kernel launched) and both
launchers' ``--trace``.  The sharded-pool broadcast case waits for the
port's sharded pool (ROADMAP Queue 1 item 7).  Engines run on the CPU
(the kernels' plain versions) at the reduced qwen1.5-0.5b."""
import contextlib
import io
import json
import tracemalloc
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import api
from repro_torch.kernels.matmul import design_tiles, kernel_blocks
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.obs import analyze as obs_analyze
from repro_torch.obs import export as obs_export
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Lifecycle, LoadGen, PagedEngine, Request, ServeConfig, ServeLoop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Engine runs are thousands of tiny ops: one torch thread, so the
    suite's other workers are not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    return cfg, lm.init(cfg, seed=0, device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    assert obs_trace.active() is None, "a test leaked an armed recorder"
    yield
    obs_trace.stop()  # idempotent; keeps one failure from cascading


def _mk_requests(cfg, *, shared_prefix=0, n=4, max_new=5, seed=7):
    rng = np.random.default_rng(seed)
    prefix = list(rng.integers(0, cfg.vocab, size=shared_prefix))
    return [Request(rid=i, prompt=prefix + list(rng.integers(0, cfg.vocab, size=3 + i)),
                    max_new=max_new)
            for i in range(n)]


def _engine(cfg, params, **kw):
    return PagedEngine(cfg, params, device="cpu", config=ServeConfig(**kw))


def _spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def _contained(inner, outer) -> bool:
    return (inner["ts"] >= outer["ts"] - 1e-6
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6)


# ---------------------------------------------------------------------------
# recorder semantics
# ---------------------------------------------------------------------------


def test_ring_buffer_evicts_oldest_first():
    rec = obs_trace.Recorder(max_events=4)
    for i in range(6):
        rec.instant(f"e{i}", cat="t")
    # 7 pushes (thread_name metadata + 6 instants) into 4 slots: the
    # metadata event and e0 / e1 fall off the front, oldest first
    assert [e["name"] for e in rec.events()] == ["e2", "e3", "e4", "e5"]
    assert rec.n_dropped == 3
    rec.clear()
    assert len(rec) == 0 and rec.n_dropped == 0


def test_event_forms_and_thread_metadata():
    rec = obs_trace.Recorder(meta={"who": "test"})
    t0 = rec.now()
    rec.complete("work", t0, cat="c", args={"k": 1})
    rec.instant("tick", cat="c")
    rec.counter("depth", 3, cat="c")
    rec.async_begin("req", 7, cat="c")
    rec.async_end("req", 7, cat="c")
    evs = rec.events()
    assert [e["ph"] for e in evs] == ["M", "X", "i", "C", "b", "e"]
    assert evs[0]["args"]["name"]  # thread name captured
    assert evs[1]["dur"] >= 0 and evs[1]["args"] == {"k": 1}
    assert evs[3]["args"]["value"] == 3
    assert evs[4]["id"] == evs[5]["id"] == "7"
    trace = obs_export.validate_trace(obs_export.to_chrome(rec))
    assert trace["metadata"]["who"] == "test"
    assert trace["metadata"]["schema_version"] == obs_export.TRACE_SCHEMA_VERSION == 1


def test_counter_track_is_time_ordered():
    rec = obs_trace.Recorder()
    for v in (1, 2, 3, 5, 8):
        rec.counter("fib", v)
    samples = [e for e in rec.events() if e["ph"] == "C"]
    ts = [e["ts"] for e in samples]
    assert ts == sorted(ts)  # monotone clock -> monotone track
    assert [e["args"]["value"] for e in samples] == [1, 2, 3, 5, 8]


def test_start_twice_raises_and_tracing_scopes():
    with obs_trace.tracing() as rec:
        assert obs_trace.active() is rec
        with pytest.raises(RuntimeError):
            obs_trace.start()
    assert obs_trace.active() is None


def test_export_roundtrips_both_formats(tmp_path):
    rec = obs_trace.Recorder(meta={"n": 1})
    rec.instant("a", cat="t", args={"x": 2})
    rec.counter("c", 1.5)
    for name in ("t.json", "t.jsonl"):
        path = str(tmp_path / name)
        written = obs_export.write(rec, path)
        loaded = obs_export.load(path)
        assert loaded["traceEvents"] == written["traceEvents"]
        assert loaded["metadata"]["n"] == 1
        obs_export.validate_trace(loaded)


def test_validate_trace_rejects_malformed():
    ok = {"name": "x", "ph": "i", "ts": 0.0, "pid": 1, "tid": 1, "s": "t"}
    obs_export.validate_trace({"traceEvents": [ok]})
    bad = [
        {**ok, "ph": "Z"},                                  # unknown phase
        {**ok, "ph": "X"},                                  # X without dur
        {**ok, "ph": "X", "dur": -1.0},                     # negative dur
        {**ok, "ph": "b"},                                  # async without id
        {**ok, "ph": "C", "args": {"value": "much"}},       # non-numeric counter
        {**ok, "args": [1, 2]},                             # args not a dict
        {k: v for k, v in ok.items() if k != "ts"},         # missing required
    ]
    for ev in bad:
        with pytest.raises(ValueError):
            obs_export.validate_trace({"traceEvents": [ev]})
    with pytest.raises(ValueError):
        obs_export.validate_trace([ok])  # no envelope


# ---------------------------------------------------------------------------
# the disabled path: zero events, zero allocations, identical tokens
# ---------------------------------------------------------------------------


def test_tracing_off_records_nothing_and_allocates_nothing(small):
    cfg, params = small
    eng = _engine(cfg, params, max_slots=2, cache_len=64, page_size=16)
    reqs = _mk_requests(cfg, n=2, max_new=3)
    eng.run([reqs[0]])  # first-use work outside the measured window
    assert obs_trace.active() is None
    tracemalloc.start()
    try:
        eng.run([reqs[1]])
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    ours = snap.filter_traces(
        [tracemalloc.Filter(True, obs_trace.__file__)]).statistics("lineno")
    assert ours == []  # the disabled path is one global read: no allocations


def test_tracing_onoff_token_streams_identical(small):
    cfg, params = small
    mk = lambda: _engine(cfg, params, max_slots=2, cache_len=64, page_size=8)  # noqa: E731
    plain = {r.rid: r.out for r in mk().run(_mk_requests(cfg, shared_prefix=16, n=3,
                                                         max_new=4))}
    with obs_trace.tracing() as rec:
        traced = {r.rid: r.out for r in mk().run(_mk_requests(cfg, shared_prefix=16, n=3,
                                                              max_new=4))}
    assert traced == plain  # observation never perturbs the computation
    assert len(rec) > 0


# ---------------------------------------------------------------------------
# instrumentation: nesting + exact counter cross-checks (sync engine)
# ---------------------------------------------------------------------------


def test_engine_trace_cross_checks_live_counters(small):
    cfg, params = small
    eng = _engine(cfg, params, max_slots=2, cache_len=64, page_size=8)
    reqs = _mk_requests(cfg, shared_prefix=16, n=4, max_new=4)
    with obs_trace.tracing() as rec:
        done = eng.run(reqs)
    assert len(done) == 4
    events = rec.events()
    report = obs_analyze.analyze(obs_export.to_chrome(rec))

    # every engine kernel-call span is inside an engine.step or
    # engine.admit span on the same thread (the worker structure)
    steps = _spans(events, "engine.step")
    admits = _spans(events, "engine.admit")
    decodes = _spans(events, "engine.decode")
    assert steps and admits and decodes
    for d in decodes:
        assert any(_contained(d, s) for s in steps if s["tid"] == d["tid"])
    prefills = _spans(events, "engine.cold_prefill") + _spans(events, "engine.suffix_prefill")
    assert prefills
    for p in prefills:
        assert any(_contained(p, a) for a in admits if a["tid"] == p["tid"])
    # every dispatch span sits inside the model step that issued it
    model_steps = decodes + prefills
    for d in _spans(events, "dispatch.matmul") + _spans(events, "dispatch.paged_attention"):
        assert any(_contained(d, s) for s in model_steps if s["tid"] == d["tid"])

    # kernel-call counts: trace == the engine's own per-name counter
    for name, calls in eng.kernel_calls.items():
        assert report[f"kernel_calls_{name}"] == calls
    assert report["kernel_calls_total"] == sum(eng.kernel_calls.values())

    # pool / prefix accounting: trace sums == live counters, exactly
    assert report["pool_pages_allocated"] == eng.pool.stats.allocated
    assert report["pool_pages_freed"] == eng.pool.stats.freed
    assert report["pool_pages_shared"] == eng.pool.stats.shared
    assert report["pool_cow_copies"] == eng.pool.stats.cow_copies
    assert report["prefix_hit_tokens"] == eng.prefix.hit_tokens
    assert report["prefix_miss_tokens"] == eng.prefix.miss_tokens
    assert report["prefix_pages_multicast"] > 0  # the shared prefix hit
    assert report["kernel_calls_decode"] == len(decodes)
    # no sharded pool: the broadcast keys read 0
    assert report["broadcast_chains"] == report["broadcast_fabric_bytes"] == 0
    eng.check()


# ---------------------------------------------------------------------------
# the async loop: request spans + TTFT decomposition vs metrics
# ---------------------------------------------------------------------------


def test_loop_trace_ttft_decomposition_matches_metrics(small):
    cfg, params = small
    trace_reqs = LoadGen(seed=3, qps=30.0, duration=0.3, vocab=cfg.vocab, max_new=6,
                         shared_prefix_len=24, shared_frac=0.5).trace()
    eng = _engine(cfg, params, max_slots=3, cache_len=128, page_size=16, pages=64)
    with obs_trace.tracing() as rec:
        loop = ServeLoop(eng)
        results = loop.run_trace(trace_reqs)
    assert {r.state for r in results.values()} == {Lifecycle.DRAINED}
    snap = loop.snapshot()
    events = rec.events()
    report = obs_analyze.analyze(obs_export.to_chrome(rec))

    # request lifecycle: one async b/e pair per submitted request
    assert report["requests_submitted"] == len(trace_reqs)
    assert report["requests_finished"] == len(trace_reqs)
    assert report["tokens_emitted"] == snap["tokens_out"]
    assert report["decode_ticks"] == snap["decode_ticks"]

    # nesting: every engine.step span sits inside a decode.tick span
    ticks = _spans(events, "decode.tick")
    for s in _spans(events, "engine.step"):
        assert any(_contained(s, t) for t in ticks if t["tid"] == s["tid"])

    # TTFT decomposition: queue_wait + prefill from span durations must
    # reproduce the metrics histograms (same values, same histogram)
    assert abs(report["ttft_decomposed_p50_ms"] - snap["ttft_p50_ms"]) < 1.0
    assert abs(report["queue_wait_p50_ms"] - snap["queue_wait_p50_ms"]) < 1.0
    # live_slots counter track exists and never exceeds max_slots
    slots = [e["args"]["value"] for e in events if e["ph"] == "C" and e["name"] == "live_slots"]
    assert slots and max(slots) <= 3


# ---------------------------------------------------------------------------
# dispatch records
# ---------------------------------------------------------------------------


def _dispatches(rec):
    return [e["args"] for e in rec.events() if e["ph"] == "X" and e["name"].startswith("dispatch.")]


def test_dispatch_records_one_span_per_call():
    """Every call records its span (the JAX package records one per jit
    trace; the port, eager, one per call), with JAX's args; the plain
    versions launch nothing and record no design or tile."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 32, generator=gen).to(torch.bfloat16)
    w = torch.randn(32, 16, generator=gen).to(torch.bfloat16)
    with obs_trace.tracing() as rec:
        for _ in range(3):
            kernels.linear(x, w)
        kernels.linear(x, w, policy="unicast")
    args = _dispatches(rec)
    assert args == [dict(op="matmul", schedule="tiled", backend="pallas", shape=[6, 32, 16],
                         dtype="bfloat16")] * 3 + [
        dict(op="matmul", schedule="unicast", backend="pallas", shape=[6, 32, 16],
             dtype="bfloat16")]


def test_dispatch_covers_op_grouped_linear_and_the_backward():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 2, 16, 8, generator=gen)
    xg = torch.randn(3, 4, 8, generator=gen).requires_grad_()
    wg = (torch.randn(3, 8, 5, generator=gen) / 3).requires_grad_()
    x = torch.randn(4, 8, generator=gen).requires_grad_()
    w = torch.randn(8, 5, generator=gen).requires_grad_()
    with obs_trace.tracing() as rec:
        kernels.op("flash_attention")(q, q, q)
        kernels.grouped_linear(xg.detach(), wg.detach())
        y = kernels.linear(x, w, activation="silu")
        n_fwd = len(_dispatches(rec))
        y.sum().backward()
        yg = kernels.grouped_linear(xg, wg)
        n_gfwd = len(_dispatches(rec))
        yg.sum().backward()
    args = _dispatches(rec)
    assert [(a["op"], a["schedule"], a["shape"]) for a in args[:n_fwd]] == [
        ("flash_attention", "pallas", [1, 2, 16, 16, 8]), ("matmul", "tiled", [4, 8, 5]),
        ("matmul", "tiled", [4, 8, 5])]
    # linear's backward re-dispatches z (silu), dA and dB: three spans
    assert [a["shape"] for a in args[n_fwd:n_gfwd - 1]] == [[4, 8, 5], [4, 5, 8], [8, 4, 5]]
    # grouped forward on one group's problem, backward dA and dB per group
    assert args[n_gfwd - 1]["shape"] == [4, 8, 5]
    assert [a["shape"] for a in args[n_gfwd:]] == [[4, 5, 8], [8, 4, 5]]
    assert all("design" not in a and "bm" not in a for a in args)


@pytest.mark.parametrize("family", ["matmul", "flash_attention", "paged_attention", "ssd",
                                    "rglru"])
def test_every_kernel_schedule_names_the_wrapper_it_launches(family):
    """A dispatch record reads the launch's design from ``Schedule.kernel``:
    every kernel schedule names a wrapper of ``KERNELS`` whose family it
    belongs to, every reference schedule none."""
    prefix = {"paged_attention": "paged_attention_", "ssd": "ssd_scan",
              "rglru": "rglru_scan"}.get(family, family)
    for sched in kernels.op(family).schedules:
        if sched.backend == "reference":
            assert sched.kernel is None
        else:
            assert sched.kernel in kernels.KERNELS and sched.kernel.startswith(prefix)
    named = [s.kernel for s in kernels.op(family).schedules if s.kernel]
    assert len(set(named)) == len(named)


@pytest.mark.parametrize("schedule,design,m,want", [
    ("tiled", "wgmma", 2048, dict(gm=1024, bm=128, bn=128, bk=64)),
    ("mcast", "wgmma-cluster", 200, dict(gm=256, bm=128, bn=128, bk=64)),
    ("mcast", "wgmma-cluster", 2049, dict(gm=512, bm=128, bn=128, bk=64)),
    ("unicast", "wgmma", 4096, dict(bm=128, bn=128, bk=64)),
    ("tiled", "wgmma-swapab", 4, dict(bm=64, bn=64, bk=64)),
    ("unicast", "wgmma-swapab-3xbf16", 45, dict(bm=64, bn=64, bk=64)),
    ("tiled", "cuda-core", 1024, dict(gm=512, bm=64, bn=64, bk=16)),
    ("mcast", "cuda-core", 2816, dict(bm=256, bn=64, bk=16)),
    ("unicast", "cuda-core", 8, dict(bm=16, bn=64, bk=32)),
])
def test_dispatch_records_the_tile_of_the_design_that_ran(schedule, design, m, want,
                                                          monkeypatch):
    """Where the kernel launched, the span carries its design and the
    design's tile (never a TPU block size); ``obs.analyze`` reads them."""
    wrapper = kernels.KERNELS[f"matmul_{schedule}"]
    sched = kernels.op("matmul").schedule(schedule)
    problem = api.Problem((m, 1024, 2816), "bfloat16")
    rec = obs_trace.Recorder()
    monkeypatch.setattr(wrapper, "launches", wrapper.launches + 1)
    monkeypatch.setattr(wrapper, "design", design)
    api._record_dispatch(rec, rec.now(), "matmul", sched, problem, wrapper.launches - 1)
    args = _dispatches(rec)[0]
    assert args == dict(op="matmul", schedule=schedule, backend="pallas",
                        shape=[m, 1024, 2816], dtype="bfloat16", design=design, **want)
    if design != "cuda-core":  # the same B fetches as the tensor-core tiles' model
        blocks, rows = kernel_blocks(m)[schedule], lambda t: t.get("gm", t["bm"])  # noqa: E731
        assert (-(-m // rows(want)), want["bn"], want["bk"]) == \
            (-(-m // rows(blocks)), blocks["bn"], blocks["bk"])
    report = obs_analyze.analyze({"traceEvents": rec.events()})
    g = want.get("gm", want["bm"])
    assert report["matmul_b_block_fetches"] == -(-m // g) * -(-2816 // want["bn"]) * \
        -(-1024 // want["bk"])
    assert design_tiles(f"matmul_{schedule}", design, m) == want


# ---------------------------------------------------------------------------
# the launchers' --trace
# ---------------------------------------------------------------------------


def _run(fn, *args, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn(*args, **kw)
    return res, out.getvalue(), err.getvalue()


SERVE_ARGS = ["--reduced", "--device", "cpu", "--requests", "3", "--max-new", "4",
              "--shared-prefix", "16", "--kv", "paged"]


def test_serve_launcher_writes_trace_and_report(small, tmp_path):
    _, params = small
    path = str(tmp_path / "serve.json")
    _, plain_out, _ = _run(launcher.main, SERVE_ARGS, params=params)
    _, out, err = _run(launcher.main, [*SERVE_ARGS, "--trace", path], params=params)
    assert out == plain_out  # stdout stays the token-stream surface
    assert f"# wrote trace {path}" in err and "0 dropped" in err
    trace = obs_export.validate_trace(obs_export.load(path))
    report = json.load(open(path + ".report.json"))
    assert obs_analyze.validate_report(report) == obs_analyze.analyze(trace)
    assert report["kernel_dispatch_matmul_tiled"] > 0 and report["trace_dropped"] == 0
    assert trace["metadata"]["tool"] == "launch.serve"
    assert obs_trace.active() is None


def test_serve_trace_lands_even_on_systemexit(small, tmp_path):
    _, params = small
    path = str(tmp_path / "fail.jsonl")

    def failing(*args):
        obs_trace.active().instant("before.exit", cat="t")
        raise SystemExit("requests did not drain: {0: 'FAILED'}")

    with mock.patch.object(launcher, "_drive", failing), pytest.raises(SystemExit):
        _run(launcher.main, [*SERVE_ARGS, "--trace", path], params=params)
    names = [e["name"] for e in obs_export.load(path)["traceEvents"]]
    assert "before.exit" in names
    obs_analyze.validate_report(json.load(open(path + ".report.json")))
    assert obs_trace.active() is None


def test_train_launcher_writes_trace(tmp_path):
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1"]
    path = str(tmp_path / "train.json")
    plain, _, _ = _run(train_launcher.main, [*args, "--ckpt-dir", str(tmp_path / "a")])
    traced, out, _ = _run(train_launcher.main,
                          [*args, "--ckpt-dir", str(tmp_path / "b"), "--trace", path])
    assert traced["losses"] == plain["losses"]
    assert f"wrote trace {path}" in out
    trace = obs_export.validate_trace(obs_export.load(path))
    assert trace["metadata"]["tool"] == "launch.train" and trace["metadata"]["n_dropped"] == 0
    report = obs_analyze.analyze(trace)
    # the forward's projections and the backward's re-dispatch, per call
    assert report["kernel_dispatch_matmul_tiled"] > 0
    assert obs_trace.active() is None
