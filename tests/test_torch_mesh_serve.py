"""The port's paged engine over a mesh of ranks against the JAX package's
``PagedEngine(mesh=)``: the page pool split over gloo ranks, each holding
its shards' pages and a null page, page chains multicast by real
collectives, on the reduced qwen1.5-0.5b with JAX's parameters
(``from_jax_params``).

The cases (``mesh_cases`` of ``_torch_dist_ref.py``) run on both
packages: JAX's in a child process on 4 forced host devices under
``backend=pallas`` with excess precision off (mode ``meshserve``), the
port's in two groups of ranks started by ``repro_torch.dist.spawn.run``
(``serve_mesh`` of ``_torch_dist_ranks.py``), 4 ranks and 2:

* ``tests/_distserve_main.py``'s scenario over 4 ranks, per
  ``mcast_mode``: the streams, the flat ``stats()`` and ``page_nbytes``
  equal JAX's 4-device mesh engine's on every rank; the 32-token prefix
  crosses the mesh 3 times, 12 pages, 96 hit tokens, each chain in 3 / 2
  / 0 point-to-point rounds (``unicast`` / ``sw_tree`` / ``hw``); each
  rank's pool tensors have 1 + 8 pages; ``check()`` passes on every rank;
* 2 ranks over 4 shards, equal to the one-device 4-shard engine and to
  JAX's; the cross-shard fork (its COW copy sent between the ranks, the
  parent's pages read on the child's rank), the same fork with the parent
  copying first (the child then writes the parent's page, sent home
  after each step), the pressured-shard preemption and a swap-in onto the
  other rank, each equal to JAX's;
* after every run, every page each rank holds equals the one-device
  engine's page of the same run, bit for bit;
* the launcher's ``--mesh --device cpu`` (4 ranks): stdout equal to JAX's
  launcher with ``--mesh``, and its ``--trace`` report's ``broadcast_*``
  keys equal to the one-device run's;
* the ``ServeLoop`` over the mesh (``loop_cases`` of
  ``_torch_dist_ranks.py``): rank 0 runs the loop, the other ranks follow
  its engine calls.  A seeded trace per mode over 4 ranks; over 2 the
  pressured pool whose preempted request swaps in on the other rank,
  ``kv_guard`` and ``kernel_fallback`` under a fault plan, the n-gram
  draft, ``close(drain=False)`` mid-trace, rejections at submit and a step
  that fails on rank 1; in a 2-rank world of its own with a 5 s collective
  timeout, the trace in real time with an 8 s gap between arrivals.  On
  every rank the flat stats, the command log and the plan's fired log
  equal rank 0's and the replay of rank 0's log on the one-device engine,
  every home page is that engine's, ``check()`` passes; the streams equal
  JAX's ``ServeLoop`` over its 4-device mesh engine and the one-shard sync
  oracle; the snapshot's keys that do not hang on the interleaving equal
  JAX's.  The launcher's ``--server --mesh`` with CI's
  ``dist-serve-smoke`` flags prints JAX's stdout with both drivers and its
  metrics file passes that job's broadcast checks;
* the engine's options over a mesh are ``tests/test_torch_mesh_opts.py``'s.

Stated tolerance: none — streams, counters and pages are held equal. The
two packages agree to fp32 summation order, which greedy streams need
unless two logits tie within that round-off (none does here).
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from _torch_dist_ref import (
    MESH,
    MESH_ARGS,
    MESH_REQUESTS,
    MODES,
    SERVER_MESH_ARGS,
    SERVER_MESH_FLAGS,
    SERVER_MESH_SEED,
    loop_keys,
    mesh_cases,
    reference,
)
from _torch_jax_ref import SEED, params_checksum
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.dist import spawn
from repro_torch.launch import serve as launcher
from repro_torch.serve import PagedEngine, Request, ServeConfig
from repro_torch.weights import from_jax_params

ROUNDS = {"unicast": 3, "sw_tree": 2, "hw": 0}


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)  # beside the suite's other workers
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = reference("meshserve", tmp_path_factory.mktemp("jax_mesh_serve"))
    assert float(out["params_checksum"]) == params_checksum(model[1])
    return json.loads(str(out["serve_json"]))


def _json(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def ranks4(model):
    return spawn.run(ranks.serve_mesh, 4, 4, model[2])


@pytest.fixture(scope="module")
def ranks2(model):
    return spawn.run(ranks.serve_mesh, 2, 2, model[2])


@pytest.fixture(scope="module")
def one_device(model):
    """The same cases on one device: (the cases, every engine built)."""
    cfg, _, params = model
    built = []
    out = {}
    for n in (4, 2):
        out[n] = _json(mesh_cases(ranks.port_serve_api(cfg, params, None, built), n))
    return out, built


def _held(got: dict, want: dict) -> None:
    assert got["out"] == want["out"]
    assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]


@pytest.mark.parametrize("mode", MODES)
def test_four_ranks_equal_jax_mesh_engine(ref, ranks4, mode):
    want = ref["cases"]["mesh4"][mode]
    for r in ranks4:
        got = _json(r["cases"][mode])
        _held(got, want)
        assert got["page_nbytes"] == want["page_nbytes"]
        st = got["stats"]
        # the 4-page prefix chain crossed the mesh once per consumer rank
        assert st["broadcast_chains"] == 3 and st["broadcast_pages"] == 12
        assert st["prefix_hit_tokens"] == 3 * 32
        assert st["broadcast_payload_bytes"] == 12 * got["page_nbytes"]
    assert ref["cases"]["leaf_devices"] == [4]  # JAX's pool is split over its 4 devices


@pytest.mark.parametrize("mode", MODES)
def test_each_chain_crosses_ranks_in_its_modes_rounds(ranks4, mode):
    for r in ranks4:
        assert r["cases"][mode]["rounds"] == ROUNDS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_each_rank_holds_its_shards_and_a_null_page(ranks4, mode):
    """4 shards of 8 pages over 4 ranks: 1 + 8 pages a rank, in every pool
    tensor; the rank's pool bytes are that many pages."""
    for i, r in enumerate(ranks4):
        got = r["cases"][mode]
        assert got["pool_pages"] == [1 + MESH["pages_per_shard"]]
        assert r["pool_bytes"][MODES.index(mode)] == \
            (1 + MESH["pages_per_shard"]) * got["page_nbytes"]


@pytest.mark.parametrize("mode", MODES)
def test_four_ranks_serve_the_one_shard_streams(model, ranks4, mode):
    """``_distserve_main.py``'s oracle: the one-device one-shard engine."""
    cfg, _, params = model
    from _torch_dist_ref import _requests, _streams

    api = ranks.port_serve_api(cfg, params)
    one = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, pages=33))
    want = _streams(one.run(_requests(api, **MESH_REQUESTS)))
    for r in ranks4:
        assert _json(r["cases"][mode]["out"]) == want


def test_two_ranks_over_four_shards_equal_one_device(ref, ranks2, one_device):
    want = one_device[0][2]["4shards"]
    for r in ranks2:
        got = _json(r["cases"]["4shards"])
        assert got["out"] == want["out"] and got["stats"] == want["stats"]
        assert got["pool_pages"] == [1 + 2 * MESH["pages_per_shard"]]
        assert got["rounds"] == ROUNDS["sw_tree"] - 1  # 1 round over 2 ranks
        _held(got, ref["cases"]["mesh2"]["4shards"])
        _held(got, ref["cases"]["one/4shards"])


@pytest.mark.parametrize("case", ["fork", "fork_late", "preempt", "reroute"])
def test_two_rank_cases_equal_jax(ref, ranks2, one_device, case):
    """The cross-shard fork (its COW copy a send between the ranks, the
    parent's pages read on the child's rank), the late fork (the child
    writes the parent's page, sent home after each step), the
    pressured-shard preemption and a swap-in onto the other rank: equal to
    JAX's 2-device mesh engine and to the one-device engine."""
    want = ref["cases"]["mesh2"][case]
    for r in ranks2:
        got = _json(r["cases"][case])
        assert got == {**want, "stats": got["stats"]}
        assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
        assert got == one_device[0][2][case]
    st = ref["cases"]["mesh2"][case]["stats"]
    if case == "preempt":
        assert st["preempted"] >= 1
    if case == "reroute":
        assert st["preempted"] == 1
    if case.startswith("fork"):
        assert st["pool_cow_copies"] >= 1


def test_every_page_equals_the_one_device_engines(ranks4, ranks2, one_device):
    """After each run, every page a rank holds (its own, not mirrors) is
    the one-device engine's page of the same run, bit for bit: the chain
    broadcasts, COW sends, swaps and mirrors' write-backs moved the right
    bytes."""
    _, built = one_device
    groups = [ranks4] * 3 + [ranks2] * (len(built) - 3)  # one_device built n=4's first
    for i, (eng, group) in enumerate(zip(built, groups)):
        k = i if i < 3 else i - 3
        got = {}
        for r in group:
            got.update(r["pages"][k])
        assert sorted(got) == list(range(1, eng.pool.num_pages))
        for pid in got:
            np.testing.assert_array_equal(got[pid], eng._pack([pid]).numpy(),
                                          err_msg=f"engine {i}, page {pid}")


def test_launcher_mesh_stdout_equals_jax(model, ref, tmp_path):
    """``--mesh`` over 4 gloo ranks prints JAX's launcher's stdout; its
    ``--trace`` (rank 0's) reports the broadcasts the one-device run's
    report does."""
    from repro_torch.obs import analyze

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        done = launcher.main([*MESH_ARGS, "--device", "cpu", "--trace",
                              str(tmp_path / "mesh.json")], params=model[2],
                             timeout=spawn.DEFAULT_TIMEOUT, join_timeout=600.0)
        launcher.main([*MESH_ARGS[:-1], "--device", "cpu", "--trace",
                       str(tmp_path / "one.json")], params=model[2])
    assert buf.getvalue() == ref["launch"] + ref["launch"]
    assert len(done) == 6
    reports = []
    for name in ("mesh", "one"):
        with open(tmp_path / f"{name}.json.report.json") as f:
            reports.append(analyze.validate_report(json.load(f)))
    keys = [k for k in reports[1] if k.startswith("broadcast")]
    assert len(keys) >= 4 and reports[1]["broadcast_pages"] > 0
    assert {k: reports[0][k] for k in keys} == {k: reports[1][k] for k in keys}


def test_ranks_must_divide_the_shards(ranks2):
    for r in ranks2:
        msg = r["refusals"]["shards"]
        assert msg.startswith("ValueError") and "2 ranks" in msg and "num_shards=3" in msg


def test_launcher_mesh_needs_the_paged_pool():
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        launcher.main(["--reduced", "--device", "cpu", "--kv", "dense", "--mesh"])


def test_engine_takes_a_bound_mesh(model):
    from repro_torch.launch.mesh import make_serve_mesh

    cfg, _, params = model
    with pytest.raises(TypeError, match="bound mesh"):
        PagedEngine(cfg, params, device="cpu", config=ServeConfig(num_shards=4),
                    mesh=make_serve_mesh(4))


# -- the ServeLoop over the mesh --------------------------------------------------

@pytest.fixture(scope="module")
def realtime(model):
    """The real-time case's own 2-rank world, its collectives' timeout
    ``REALTIME_TIMEOUT`` (5 s), shorter than its gap between arrivals."""
    return spawn.run(ranks.serve_loop_realtime, 2, model[2], timeout=ranks.REALTIME_TIMEOUT)


@pytest.fixture(scope="module")
def loop_oracle(model):
    """The one-shard sync oracle: ``PagedEngine.run`` of the loop trace on
    one device, one shard (``_distserve_main.py``'s engine)."""
    cfg, _, params = model
    one = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, pages=33))
    done = one.run([Request(rid=a.rid, prompt=list(a.prompt), max_new=a.max_new)
                    for a in ranks._loop_trace(cfg)])
    return {str(r.rid): list(r.out) for r in done}


def _streams(out: dict) -> dict:
    return {str(rid): list(toks) for rid, toks in out.items()}


def _loop_held(group: list, case: str | None = None) -> dict:
    """A loop case's run on every rank of ``group`` (each rank's result, or
    its ``loop`` entry ``case``): no error; every rank's flat stats,
    command log and fired log equal rank 0's and the replay of rank 0's log
    on the one-device engine, every rank's requests' tokens the replay's,
    and every rank's home pages that engine's pages, bit for bit.  Returns
    rank 0's run."""
    runs = [r if case is None else r["loop"][case] for r in group]
    first = runs[0]
    assert first["error"] is None, first["error"]
    rep = first["replay"]
    pages = {}
    for got in runs:
        assert got["error"] is None, got["error"]
        assert got["stats"] == rep["stats"]
        assert got["log"] == first["log"]
        assert got["fired"] == rep["fired"]
        assert {rid: got["out"][rid] for rid in rep["out"]} == rep["out"]
        pages.update(got["pages"])
    assert sorted(pages) == sorted(rep["pages"])
    for pid, want in rep["pages"].items():
        np.testing.assert_array_equal(pages[pid], want, err_msg=f"page {pid}")
    return first


@pytest.mark.parametrize("mode", MODES)
def test_loop_over_four_ranks_equals_jax_mesh_loop(ref, ranks4, loop_oracle, mode):
    """Rank 0's ``ServeLoop`` with 3 ranks following, per mode: the streams
    of JAX's ``ServeLoop`` over its 4-device mesh engine and of the sync
    oracle; the snapshot's interleaving-free keys JAX's; the prefix chain
    broadcast between ranks."""
    first = _loop_held(ranks4, mode)
    want = ref["cases"]["loop"][mode]
    assert set(first["states"].values()) == {"DRAINED"} and want["states"] == ["DRAINED"]
    assert _streams(first["out"]) == want["out"] == loop_oracle
    assert _json(first["keys"]) == want["keys"]
    assert first["keys"]["mcast_mode"] == mode and first["stats"]["broadcast_chains"] >= 1


def test_loop_preempted_request_swaps_in_on_the_other_rank(ref, ranks2):
    """The pressured pool: request 0's page fault preempts request 2, which
    swaps back in on the other rank; the streams are the sync run's, on
    JAX's 2-device mesh engine."""
    first = _loop_held(ranks2, "preempt")
    assert set(first["states"].values()) == {"DRAINED"}
    assert first["stats"]["preempted"] >= 1
    assert any(len(s) == 3 and s[1] != s[2] for s in first["swaps"])
    assert _streams(first["out"]) == ref["cases"]["mesh2"]["reroute"]["out"]


def test_loop_under_a_fault_plan_over_two_ranks(ranks2):
    """``kv_guard`` and ``kernel_fallback`` under ``kernel.raise``,
    ``kernel.nan`` and ``pool.alloc``: every site fired once, alike on
    both ranks and in the replay; two fallbacks; every request drained."""
    first = _loop_held(ranks2, "plan")
    assert set(first["states"].values()) == {"DRAINED"}
    assert sorted(site for site, _ in first["fired"]) == \
        sorted(site for site, _ in ranks.LOOP_PLAN)
    assert first["stats"]["kernel_fallbacks"] == 2


def test_loop_speculating_over_two_ranks(ref, ranks2):
    """The n-gram draft at k = 2: the streams of JAX's mesh loop."""
    first = _loop_held(ranks2, "spec")
    assert set(first["states"].values()) == {"DRAINED"}
    assert first["stats"]["spec_rounds"] >= 1
    assert _streams(first["out"]) == ref["cases"]["loop"]["sw_tree"]["out"]


def test_loop_abort_mid_trace_leaves_every_rank_audit_green(ranks2, loop_oracle):
    """``close(drain=False)`` once a request decodes: the live slots fail
    as ``shutdown``, their pages released on every rank (``check()``
    passes there and in the replay); what drained is the oracle's."""
    first = _loop_held(ranks2, "abort")
    states = first["states"]
    assert "FAILED" in states.values()
    assert all(first["errors"][rid] == "shutdown" for rid, st in states.items()
               if st == "FAILED")
    for rid, st in states.items():
        if st == "DRAINED":
            assert list(first["out"][rid]) == loop_oracle[str(rid)]


def test_loop_rejects_at_submit_over_a_mesh(ranks2):
    """``too-long``, ``too-large`` and ``queue-full`` at submit: typed, and
    no command reaches the engine of any rank."""
    first = ranks2[0]["loop"]["reject"]
    assert first["error"] is None
    assert first["keys"]["rejected_too-long"] == first["keys"]["rejected_too-large"] == \
        first["keys"]["rejected_queue-full"] == 1
    assert first["keys"]["requests_rejected"] == first["keys"]["requests_total"] == 3
    for r in ranks2:
        assert r["loop"]["reject"]["log"] == []


def test_loop_step_failing_on_one_rank_ends_every_rank(ranks2):
    """A step that fails on rank 1 and is not retried: both ranks end with
    ``MeshStepFailed`` (rank 1's chained to its error), none waits."""
    got = [r["loop"]["broken"] for r in ranks2]
    for r in got:
        assert r["error"].startswith("MeshStepFailed") and "[1]" in r["error"]
        assert r["seconds"] < 60
    assert got[1]["cause"] == "ValueError"


def test_loop_waits_out_a_gap_longer_than_the_collective_timeout(ref, realtime):
    """The trace in real time, its second half ``REALTIME_GAP`` (8 s) after
    the first, in a world whose collectives time out after 5 s: rank 0's
    keep-alives carry the follower through the gap."""
    first = _loop_held(realtime)
    assert set(first["states"].values()) == {"DRAINED"}
    assert first["seconds"] > ranks.REALTIME_GAP > ranks.REALTIME_TIMEOUT
    assert _streams(first["out"]) == ref["cases"]["loop"]["sw_tree"]["out"]


@pytest.fixture(scope="module")
def params5():
    """JAX's parameters at the launcher's seed 5, converted."""
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True),
                          jax.random.PRNGKey(SERVER_MESH_SEED))
    return params_checksum(jparams), from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.mark.parametrize("driver", ["sync", "loop"])
def test_launcher_server_over_a_mesh_prints_jax_lines(ref, params5, tmp_path, driver):
    """``--server --mesh`` with CI's ``dist-serve-smoke`` flags over 4 gloo
    ranks: stdout equal to JAX's launcher's ``--mesh`` loop run and its
    one-device sync oracle; the loop's metrics file passes the job's
    broadcast checks and carries JAX's interleaving-free keys."""
    want = ref["server"]
    assert params5[0] == want["params_checksum"]
    path = tmp_path / "metrics.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        done = launcher.main([*SERVER_MESH_ARGS, "--device", "cpu", "--server-driver", driver,
                              *SERVER_MESH_FLAGS, "--metrics-json", str(path)],
                             params=params5[1], timeout=spawn.DEFAULT_TIMEOUT,
                             join_timeout=600.0)
    assert buf.getvalue() == want["loop"] == want["sync"]
    assert len(done) > 1
    if driver == "sync":
        return
    with open(path) as f:
        m = json.load(f)
    assert m["num_shards"] == 4 and m["mcast_mode"] == "sw_tree"
    assert m["broadcast_chains"] >= 1 and m["broadcast_pages"] >= m["broadcast_chains"]
    assert m["broadcast_fabric_bytes"] > 0
    assert m["requests_drained"] == m["requests_total"] > 1
    assert sum(m[f"shard{s}_in_use"] + m[f"shard{s}_free_pages"] for s in range(4)) == 4 * 16
    assert loop_keys(m) == loop_keys(want["metrics"])
