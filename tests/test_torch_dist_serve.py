"""The port's sharded page pool on one device against the JAX package's:
``PagedEngine(num_shards=S)`` with page-chain broadcast, on the reduced
qwen1.5-0.5b with JAX's parameters (``from_jax_params``).

The cases (``engine_cases`` of ``_torch_dist_ref.py``) run on both
packages — JAX's in a child process under ``backend=pallas`` with excess
precision off, the port's here on its plain versions:

* the 4-shard engine per ``mcast_mode``, cold and with a 32-token shared
  prefix: the same streams, the same flat ``stats()`` (the ``broadcast_*``
  counters, the ``shard{s}_*`` gauges, the prefix hits, the pool's
  counters) and ``page_nbytes``; the shared prefix is prefilled once and
  broadcast, never re-prefilled, to the other three shards;
* JAX's engine cases of ``tests/test_sharded_serve.py``: the cross-shard
  fork whose COW copy lands on the child's shard, preemption restricted
  to the pressured shard, one shard's alloc fault under ``kv_guard``, and
  the ``stats_delta`` round trip of the shard gauges (1 and 4 shards);
* per-shard prefix copies, broadcast commits and eviction on the pool and
  prefix tree alone, both packages in this process;
* the engine's defaults and the metrics snapshot's broadcast surface;
* the launcher's traced sharded run: the same stdout as JAX's launcher,
  and ``obs.analyze``'s ``broadcast_*`` keys equal to JAX's report.

``PagedEngine(mesh=...)`` and the launcher's ``--mesh``:
``tests/test_torch_mesh_serve.py``.

Stated tolerance: none — streams, counters and gauges are held equal.
The two sides agree to fp32 summation order, which greedy streams need
unless two logits tie within that round-off (none does here).
"""
import contextlib
import io
import json
import os
from types import SimpleNamespace

import jax
import pytest
import torch

from _torch_dist_ref import MODES, TRACE_ARGS, engine_cases, reference
from _torch_jax_ref import SEED, params_checksum
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.serve import PagePool as JaxPagePool
from repro.serve import PrefixCache as JaxPrefixCache
from repro_torch.configs import get_config
from repro_torch.dist import mcast
from repro_torch.launch import serve as launcher
from repro_torch.obs import analyze
from repro_torch.serve import (
    Fault,
    FaultPlan,
    PagedEngine,
    PagePool,
    PrefixCache,
    Request,
    ServeConfig,
    ServeMetrics,
    validate_snapshot,
)
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(1)  # beside the suite's other workers
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = reference("serve", tmp_path_factory.mktemp("jax_dist_serve"))
    assert float(out["params_checksum"]) == params_checksum(model[1])
    return json.loads(str(out["serve_json"]))


def _api(cfg, params):
    return SimpleNamespace(
        PagedEngine=lambda **kw: PagedEngine(cfg, params, device="cpu", **kw),
        Request=Request, ServeConfig=ServeConfig, Fault=Fault, FaultPlan=FaultPlan)


@pytest.fixture(scope="module")
def port(model):
    cfg, _, params = model
    return json.loads(json.dumps(engine_cases(_api(cfg, params))))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["cold", "prefix"])
def test_four_shards_equal_jax(ref, port, kind, mode):
    got, want = port[f"{kind}/{mode}"], ref["cases"][f"{kind}/{mode}"]
    assert got["out"] == want["out"]
    assert got["page_nbytes"] == want["page_nbytes"]
    assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
    st = got["stats"]
    assert st["num_shards"] == 4
    for s in range(4):
        assert st[f"shard{s}_free_pages"] + st[f"shard{s}_in_use"] == 8
    if kind == "cold":
        assert st["broadcast_chains"] == 0  # nothing cached to broadcast
        return
    # the 32-token prefix (4 pages) was prefilled once, on request 0's
    # shard, then broadcast to each of the other three shards
    assert st["broadcast_chains"] == 3 and st["broadcast_pages"] == 12
    assert st["prefix_hit_tokens"] == 3 * 32
    assert st["broadcast_payload_bytes"] == 12 * got["page_nbytes"]
    assert st["broadcast_fabric_bytes"] == \
        st["broadcast_payload_bytes"] * mcast.bytes_model(1, 4, per_device=True)[mode]


def test_sharded_streams_equal_single_shard(model, port):
    """Decode math is page-placement independent: the 4-shard runs serve the
    one-shard engine's streams."""
    cfg, _, params = model
    from _torch_dist_ref import _requests, _streams

    api = _api(cfg, params)
    one = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, pages=33))
    assert _streams(one.run(_requests(api, n=4, shared_prefix=32, max_new=5))) == \
        port["prefix/hw"]["out"]
    one.check()


def test_cross_shard_fork_cows_onto_the_childs_shard(ref, port):
    got, want = port["fork"], ref["cases"]["fork"]
    assert got == {**want, "stats": got["stats"]}
    assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
    assert got["child_shard"] == 1 and got["zero_copy"] and got["shared_refs"] >= 2
    assert got["writable"] and got["moved"] and got["new_page_shard"] == 1
    assert got["stats"]["cow_copies"] >= 1
    assert got["out"]["0"] == got["out"]["1"]  # both lineages decode alike


def test_preemption_restricted_to_the_pressured_shard(ref, port):
    got, want = port["preempt"], ref["cases"]["preempt"]
    assert got == {**want, "stats": got["stats"]}
    assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
    assert got["admitted"] == [True] * 3 and got["victims"] == [True, True]
    assert got["stats"]["preempted"] >= 1 and got["roomy_preempted"] == 0
    assert got["out"] == got["roomy"]  # swap-out / swap-in restored every page


def test_shard_alloc_fault_contained(ref, port):
    got, want = port["fault"], ref["cases"]["fault"]
    assert got == {**want, "stats": got["stats"]}
    assert {k: got["stats"][k] for k in want["stats"]} == want["stats"]
    assert got["fired"] and got["out"] == got["calm"] and len(got["out"]) == 4


@pytest.mark.parametrize("n", [1, 4])
def test_stats_delta_shard_gauges_round_trip(ref, port, n):
    got, want = port[f"delta/{n}"], ref["cases"][f"delta/{n}"]
    for part in ("d1", "d2", "now"):
        assert {k: got[part][k] for k in want[part]} == want[part], part
    d2, now = got["d2"], got["now"]
    assert got["d1"]["pool_allocated"] > 0
    assert d2["pool_allocated"] == 0 and d2["pool_freed"] == 0
    for s in range(n):
        assert d2[f"shard{s}_free_pages"] == now[f"shard{s}_free_pages"]
        assert d2[f"shard{s}_in_use"] == now[f"shard{s}_in_use"]


def _prefix_story(pool_cls, cache_cls) -> list:
    """JAX's per-shard prefix case, step by step: what each call returns."""
    pool = pool_cls(9, 8, num_shards=2)
    cache = cache_cls(pool)
    toks = list(range(17))  # 2 full shareable pages + the decode page
    seen = []
    p0 = pool.alloc(2, 0)
    cache.insert(toks, p0, shard=0)
    pool.release(p0)
    seen.append(cache.match(toks, shard=1))
    remote = cache.remote_continuation(toks, shard=1, n_local=0)
    seen.append([pid for _, pid in remote] == p0)
    p1 = pool.alloc(2, 1)
    cache.commit_broadcast([n for n, _ in remote], 1, p1)
    pool.release(p1)
    got, n = cache.match(toks, shard=1)
    seen.append((got == p1, n))
    pool.release(got)
    cache.pool.check([cache.pages()])
    seen += [cache.evictable_pages(shard=1), cache.evict(2, shard=1), pool.free_pages_on(1),
             cache.match(toks, shard=0)[1]]
    pool.release(p0)
    pool.check([cache.pages()])
    return seen


def test_prefix_per_shard_copies_broadcast_and_evict():
    got = _prefix_story(PagePool, PrefixCache)
    assert got == _prefix_story(JaxPagePool, JaxPrefixCache)
    assert got == [([], 0), True, (True, 16), 2, 2, 4, 16]


def test_default_pool_fills_whole_shards(model):
    cfg, _, params = model
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, num_shards=3))
    assert (eng.pool.num_pages - 1) % 3 == 0
    assert eng.pool.pages_per_shard >= 64 // 8  # each shard fits a request
    total = sum(t.numel() * t.element_size() for c in eng.caches for t in c)
    assert eng.page_nbytes == total // eng.pool.num_pages


def test_pinned_shard_out_of_range_raises(model):
    cfg, _, params = model
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, num_shards=2))
    with pytest.raises(ValueError, match="pinned shard 2"):
        eng.run([Request(rid=0, prompt=[1, 2, 3], max_new=2, shard=2)])


def test_snapshot_carries_the_broadcast_surface(model):
    cfg, _, params = model
    snap = validate_snapshot(ServeMetrics().snapshot())
    assert snap["num_shards"] == 1 and snap["broadcast_pages"] == 0
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, num_shards=4, pages_per_shard=8,
        mcast_mode="sw_tree"))
    from _torch_dist_ref import _requests

    eng.run(_requests(_api(cfg, params), n=4, shared_prefix=32, max_new=3))
    snap = validate_snapshot(ServeMetrics().snapshot(engine=eng))
    assert snap["num_shards"] == 4 and snap["mcast_mode"] == "sw_tree"
    assert snap["broadcast_pages"] == 12 and snap["broadcast_chains"] == 3
    assert snap["broadcast_fabric_bytes"] == 2 * snap["broadcast_payload_bytes"]
    for s in range(4):
        assert snap[f"shard{s}_free_pages"] + snap[f"shard{s}_in_use"] == 8


def test_traced_launcher_and_broadcast_report_equal_jax(model, ref, tmp_path):
    _, _, params = model
    path = str(tmp_path / "trace.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        launcher.main([*TRACE_ARGS, "--device", "cpu", "--trace", path], params=params)
    want = ref["trace"]
    assert buf.getvalue() == want["stdout"]
    with open(path + ".report.json") as f:
        report = json.load(f)
    keys = [k for k in want["report"] if k.startswith("broadcast")]
    assert len(keys) >= 4
    assert {k: report[k] for k in keys} == {k: want["report"][k] for k in keys}
    assert report["broadcast_pages"] > 0
    assert analyze.validate_report(report) is not None
    assert os.path.getsize(path) > 0
