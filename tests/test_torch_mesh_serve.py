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
* what the mesh refuses (the ``ServeLoop``) names ROADMAP Queue 1 item 13;
  the engine's options over a mesh are ``tests/test_torch_mesh_opts.py``'s.

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
from _torch_dist_ref import MESH, MESH_ARGS, MESH_REQUESTS, MODES, mesh_cases, reference
from _torch_jax_ref import SEED, params_checksum
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.dist import spawn
from repro_torch.launch import serve as launcher
from repro_torch.serve import PagedEngine, ServeConfig
from repro_torch.weights import from_jax_params

ROUNDS = {"unicast": 3, "sw_tree": 2, "hw": 0}
ITEM = "ROADMAP Queue 1 item 13"


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


@pytest.mark.parametrize("name", ["server"])
def test_engine_refusals_name_the_item(ranks2, name):
    for r in ranks2:
        assert r["refusals"][name].startswith("NotImplementedError") and ITEM in \
            r["refusals"][name]


def test_ranks_must_divide_the_shards(ranks2):
    for r in ranks2:
        msg = r["refusals"]["shards"]
        assert msg.startswith("ValueError") and "2 ranks" in msg and "num_shards=3" in msg


@pytest.mark.parametrize("flags", [["--server"]])
def test_launcher_refusals_name_the_item(flags):
    with pytest.raises(NotImplementedError, match=ITEM):
        launcher.main(["--reduced", "--device", "cpu", "--kv", "paged", "--num-shards", "2",
                       "--mesh", *flags])


def test_launcher_mesh_needs_the_paged_pool():
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        launcher.main(["--reduced", "--device", "cpu", "--kv", "dense", "--mesh"])


def test_engine_takes_a_bound_mesh(model):
    from repro_torch.launch.mesh import make_serve_mesh

    cfg, _, params = model
    with pytest.raises(TypeError, match="bound mesh"):
        PagedEngine(cfg, params, device="cpu", config=ServeConfig(num_shards=4),
                    mesh=make_serve_mesh(4))
