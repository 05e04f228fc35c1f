"""The chaos suite against the JAX package's: ``tests/test_chaos.py``'s
cases and ``tests/test_spec_decode.py``'s two guarded ones
(``test_rejected_pages_rolled_back_under_kv_guard``,
``test_chaos_pool_cow_faults_mid_verify``) on the port's ``PagedEngine``.

Every engine case is written once (``_torch_chaos_cases.py``) and runs
through both engines on the reduced qwen1.5-0.5b with the same converted
parameters and the same seeded :class:`FaultPlan`: JAX's in a child
process under ``backend=pallas`` (``_torch_jax_ref.py chaos``), the
port's here on its CPU default.  Each case requires the port's result
equal to JAX's — the ``plan.fired`` log, the token streams, the typed
rejections and errors, ``stats()`` (fallbacks, quarantined pages,
requeues, preemptions, …) and the fallback counters — and then the JAX
test's own degradation contract on it: every request completes
token-identical to the fault-free run or fails typed, and the pool audit
(``engine.check()``) is green.

The port's own cases: a primary step that fails after it has written
some layers of the in-place pools (decode, verify, cold and suffix
prefill; bf16 and int8 pools) and is retried on the reference backend
must leave the pools bit-equal to a step run on the reference backend
from the start; and a kernel that cannot be built or launched is never
retried, the fallback armed or not.
"""
import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import _torch_chaos_cases as cc
from _torch_jax_ref import SEED, params_checksum
from _torch_util import jax_reference
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.serve import faults as jax_faults
from repro.serve import pagepool as jax_pagepool
from repro.serve import scheduler as jax_scheduler
from repro_torch import kernels
from repro_torch.kernels import _build, api
from repro_torch.models import lm
from repro_torch.serve import Fault, FaultPlan, PagePool, Rejected, Scheduler, ServeConfig
from repro_torch.serve import faults as torch_faults
from repro_torch.weights import from_jax_params

pytestmark = pytest.mark.chaos

CHUNK_IDS = list(cc.CHUNKS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Engine runs are thousands of tiny ops: one torch thread, so the
    suite's other workers are not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pkg():
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    out = cc.torch_package(from_jax_params(jax.device_get(jparams), device="cpu"))
    out.checksum = params_checksum(jparams)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory, pkg):
    out = jax_reference("chaos", tmp_path_factory.mktemp("jax_chaos"))
    assert float(out["params_checksum"]) == pkg.checksum
    return json.loads(str(out["chaos_json"]))


@pytest.fixture(scope="module")
def case(pkg, ref):
    """``case(name)``: the port's result of a case, held equal to JAX's."""
    fns, seen = cc.cases(), {}

    def get(name):
        if name not in seen:
            seen[name] = json.loads(json.dumps(fns[name](pkg)))
            assert seen[name] == ref[name], name
        return seen[name]

    return get


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("faults", [torch_faults, jax_faults], ids=["torch", "jax"])
def test_faultplan_validation_and_arming(faults):
    """The port's copy of the plan behaves as JAX's, draw for draw."""
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.Fault("pool.bogus")
    with pytest.raises(ValueError, match="count"):
        faults.Fault("pool.alloc", at=-1)
    with pytest.raises(ValueError, match="prob"):
        faults.Fault("pool.alloc", prob=1.5)
    plan = faults.FaultPlan([faults.Fault("pool.alloc", at=1, count=2)])
    with plan:
        with pytest.raises(RuntimeError, match="already armed"):
            faults.FaultPlan().__enter__()
        assert plan.fires("pool.alloc") is None  # hit 0
        assert plan.fires("pool.alloc") is not None  # hits 1, 2 fire
        assert plan.fires("pool.alloc") is not None
        assert plan.fires("pool.alloc") is None  # hit 3
    assert plan.fired == [("pool.alloc", 1), ("pool.alloc", 2)]
    # seeded prob plans are reproducible, and the same in both packages
    draws = []
    for mod in (faults, torch_faults, jax_faults):
        p = mod.FaultPlan([mod.Fault("pool.cow", prob=0.5)], seed=3)
        draws.append([p.fires("pool.cow") is None for _ in range(32)])
    assert draws[0] == draws[1] == draws[2]
    assert not all(draws[0])


def test_typed_rejection_reasons():
    for pool_cls, sched_cls, rej_cls in ((PagePool, Scheduler, Rejected),
                                         (jax_pagepool.PagePool, jax_scheduler.Scheduler,
                                          jax_scheduler.Rejected)):
        pool = pool_cls(10, 4)  # 9 usable pages
        sched = sched_cls(pool, None, watermark=2)
        assert sched.check_admission(7) is None
        rej = sched.check_admission(8)
        assert rej.reason == "watermark" and rej.retry_after_pages == 1
        assert not rej  # falsy: `while queue and admit()` loops keep working
        assert sched.check_admission(20).reason == "pool-dry"
        assert isinstance(rej, rej_cls)


# ---------------------------------------------------------------------------
# pool exhaustion at every allocation site, and the seeded matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNK_IDS)
@pytest.mark.parametrize("at", cc.EXHAUSTION_ATS)
def test_pool_exhaustion_recovers_token_identical(case, chunk, at):
    got = case(f"exhaustion-{chunk}-{at}")
    assert got["fired"] == [["pool.alloc", at]]
    assert got["out"] == case(f"baseline-shared-{chunk}")["out"]
    assert not got["failed"]


@pytest.mark.parametrize("chunk", CHUNK_IDS)
@pytest.mark.parametrize("spec", list(cc.MATRIX))
def test_fault_matrix_under_memory_pressure(case, chunk, spec):
    got = case(f"matrix-{chunk}-{spec}")
    assert got["out"] == case(f"baseline-pressure-{chunk}")["out"]
    assert not got["failed"]
    if spec != "seeded-mix":  # a deterministic fault really fired
        assert got["fired"]


def test_swap_blob_checksum_detects_corruption(case):
    got = case("swap-blob-checksum")
    assert got["swap_dropped"] == 1
    assert got["out"] == got["want"]
    assert not got["failed"]


# ---------------------------------------------------------------------------
# corrupted shared chains: detect at the sharing point, quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNK_IDS)
def test_corrupt_chain_quarantined_all_tokens_identical(case, chunk):
    got = case(f"corrupt-chain-{chunk}")
    assert got["fired"] == [["page.corrupt", 0]]
    assert got["stats"]["quarantined_pages"] > 0
    assert got["stats"]["degrade_requeues"] >= 1  # the chain's owner was replayed
    assert got["out"] == case(f"baseline-shared-{chunk}")["out"]
    assert not got["failed"]


def test_manual_corruption_detected_only_with_guard(case):
    got = case("manual-corruption")
    assert got["guard=True"]["stats"]["quarantined_pages"] > 0
    assert got["guard=True"]["out"] == got["solo"]  # quarantine forced the cold path
    assert got["guard=False"]["stats"]["quarantined_pages"] == 0  # shared blind


def test_degrade_requeue_cap_fails_typed(case):
    got = case("requeue-cap")
    assert got["admitted"]
    assert [rid for rid, _ in got["failed_at_admission"]] == [0]
    assert "quarantined" in got["failed_at_admission"][0][1]
    assert got["requeued"] == 0
    assert set(got["out"]) == {"1"}


# ---------------------------------------------------------------------------
# kernel raise / NaN: retry once on the reference backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", CHUNK_IDS)
def test_kernel_raise_falls_back_token_identical(case, chunk):
    got = case(f"kernel-raise-{chunk}")
    # the retried step runs on the reference numerics; here they pick the
    # baseline's tokens, as they do in the JAX suite
    assert got["out"] == case(f"baseline-shared-{chunk}")["out"]
    assert got["stats"]["kernel_fallbacks"] == 1
    assert got["fallback"]["fallbacks"] == 1 and got["fallback"]["raised"] == 1
    assert "InjectedFault" in got["fallback"]["last_error"]


def test_kernel_nan_output_guard_falls_back(case):
    got = case("kernel-nan")
    assert got["out"] == case("baseline-shared-one-shot")["out"]
    assert got["stats"]["kernel_fallbacks"] == 1
    assert got["fallback"]["numeric_trips"] == 1


def test_kernel_raise_without_fallback_propagates(case):
    got = case("kernel-raise-unguarded")
    assert got["error"] == "InjectedFault"
    assert "injected kernel fault" in got["message"]


# ---------------------------------------------------------------------------
# rejection hygiene + guards-off equivalence
# ---------------------------------------------------------------------------


def test_rejected_admission_restores_refcounts_exactly(case):
    got = case("rejected-admission")
    assert got["typed"] and got["reason"] == "watermark"
    assert got["refs_unchanged"]
    assert got["rejections"] == {"watermark": 1}


def test_no_free_slot_rejection(case):
    got = case("no-free-slot")
    assert got["typed"] and got["reason"] == "no-free-slot"
    assert got["retry_after_pages"] == 0
    assert set(got["out"]) == {"0", "1"}


def test_guards_on_tokens_match_guards_off(case):
    got = case("guards-on")
    assert got["out"] == case("baseline-shared-one-shot")["out"]
    assert got["stats"]["kernel_fallbacks"] == 0 and got["stats"]["quarantined_pages"] == 0
    assert got["stats"]["failed"] == 0


# ---------------------------------------------------------------------------
# the speculative suite's guarded cases
# ---------------------------------------------------------------------------


def test_rejected_pages_rolled_back_under_kv_guard(case):
    got = case("spec-rollback-under-guard")
    assert got["spec"]["out"] == got["plain"]["out"]
    assert got["spec"]["stats"]["spec_rollback_pages"] > 0
    # conservation: nothing leaked beyond what the prefix cache retains
    assert got["spec"]["allocated_minus_freed"] == got["spec"]["prefix_pages"]


def test_chaos_pool_cow_faults_mid_verify(case):
    got = case("spec-cow-fault-mid-verify")
    assert got["faulted"]["fired"] == [["pool.cow", 0]]  # fired mid-verify, absorbed
    assert got["faulted"]["out"] == got["baseline"]["out"]
    assert got["faulted"]["cow"] >= 1 and got["faulted"]["stats"]["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# the port's own: a partly written step, retried
# ---------------------------------------------------------------------------


def _scatter_two_layers(dense, pools, table, length):
    lm.prefill_to_pages(dense[:2], pools[:2], table, length)


def _failing(step: str):
    """The fault of ``step``'s primary: it fails in layer 1 of 3 — after
    layer 0 and layer 1's own K/V rows were written (the rows precede the
    attention call that fails) — or, for the cold prefill, in the scatter,
    after two layers' pages were written.  Later calls (the retry) run."""
    calls = []

    def failing(fn, at, partial=None):
        def call(*args, **kw):
            calls.append(fn)
            if len(calls) == at:
                if partial is not None:
                    partial(*args, **kw)
                raise RuntimeError("kernel failed after writing some layers")
            return fn(*args, **kw)
        return call

    if step == "cold_prefill":
        return mock.patch.object(lm, "prefill_to_pages",
                                 failing(lm.prefill_to_pages, 1, _scatter_two_layers))
    return mock.patch.multiple(
        api, paged_attention_decode=failing(api.paged_attention_decode, 2),
        paged_attention_prefill=failing(api.paged_attention_prefill, 2))


def _engine(pkg, kv_dtype, step, fallback=True):
    spec = dict(spec_k=4, draft_model="ngram") if step == "verify" else {}
    eng = pkg.engine(config=ServeConfig(kv_dtype=kv_dtype, kernel_fallback=fallback,
                                        max_slots=2, cache_len=64, page_size=8, **spec))
    reqs = cc.requests(pkg, shared_prefix=16, n=3, max_new=8)
    if step in ("decode", "verify"):
        assert eng._admit(reqs[0]) is True and eng._admit(reqs[1]) is True
    elif step == "suffix_prefill":
        assert eng._admit(reqs[0]) is True  # caches the shared prefix
    return eng, reqs


def _act(eng, reqs, step):
    """Run ``step`` once; every request's tokens after it."""
    if step in ("decode", "verify"):
        eng.step()
    else:
        assert eng._admit(reqs[1 if step == "suffix_prefill" else 0]) is True
    return [list(r.out) for r in reqs]


def _pools(eng):
    return [tuple(t.clone() for t in c) for c in eng.caches]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for ca, cb in zip(a, b) for x, y in zip(ca, cb))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("step", ["decode", "verify", "cold_prefill", "suffix_prefill"])
def test_retry_after_a_partly_written_step_leaves_the_reference_step_pools(pkg, step,
                                                                          kv_dtype):
    """The in-place pools under the fallback: a primary that wrote some
    layers and failed, then its reference retry, leaves pools bit-equal
    to the same step run on the reference backend from the start (and the
    same tokens); page 0, the padded-write sink, included."""
    eng_a, reqs_a = _engine(pkg, kv_dtype, step)
    eng_b, reqs_b = _engine(pkg, kv_dtype, step)
    assert _equal(eng_a.caches, eng_b.caches)
    kernels.reset_fallback_stats()
    with _failing(step):
        got = _act(eng_a, reqs_a, step)
    assert eng_a.n_fallback == 1 and kernels.fallback_stats().raised == 1
    with kernels.use_policy("reference"):
        want = _act(eng_b, reqs_b, step)
    assert got == want
    assert eng_a.kernel_calls == eng_b.kernel_calls
    assert _equal(eng_a.caches, eng_b.caches)
    eng_a.check()


@pytest.mark.parametrize("step", ["decode", "cold_prefill"])
def test_the_failed_primary_wrote_rows_the_retry_replaces(pkg, step):
    """The bit-equality above is not vacuous: the failing primary (no
    fallback armed here) changed the pools, in the layers it reached
    only, and with other bytes than the reference step writes there."""
    eng, reqs = _engine(pkg, "bf16", step, fallback=False)
    ref_eng, ref_reqs = _engine(pkg, "bf16", step, fallback=False)
    before = _pools(eng)
    with _failing(step), pytest.raises(RuntimeError, match="after writing some layers"):
        _act(eng, reqs, step)
    with kernels.use_policy("reference"):
        _act(ref_eng, ref_reqs, step)
    assert not _equal(before[:2], eng.caches[:2])  # layers 0 and 1 written
    assert _equal(before[2:], eng.caches[2:])  # layer 2 never reached
    assert not _equal(eng.caches[:2], ref_eng.caches[:2])


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_a_kernel_that_cannot_build_or_launch_is_not_retried(pkg, monkeypatch, tmp_path,
                                                              failure):
    """With ``kernel_fallback`` armed, a decode kernel whose library
    cannot be built (no ``nvcc``, nothing built yet) or whose launch
    reports a CUDA error raises out of the step: the engine must not
    serve it on the plain version.  Nothing is counted as a fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)

    def decode(*args, **kw):  # the wrapper's first two acts on a CUDA tensor
        if failure == "build":
            _build.load("paged_attention_decode")
        _build.check(700, "paged_attention_decode")

    eng, reqs = _engine(pkg, "bf16", "decode")
    kernels.reset_fallback_stats()
    with mock.patch.object(api, "paged_attention_decode", decode), \
            pytest.raises(_build.KernelUnavailable,
                          match="nvcc not found" if failure == "build" else "cudaError 700"):
        eng.step()
    assert eng.n_fallback == 0 and eng.stats()["kernel_fallbacks"] == 0
    assert kernels.fallback_stats().fallbacks == 0


def test_fault_plans_reach_the_engine_through_chaos(pkg):
    """``ServeConfig(chaos=...)`` builds the seeded plan the launcher arms;
    a ``FaultPlan`` armed around a run is consulted by the engine."""
    conf = ServeConfig(chaos=("pool.alloc:0.5",), seed=3)
    plan = conf.fault_plan()
    assert [(f.site, f.prob) for f in plan.faults] == [("pool.alloc", 0.5)]
    eng = pkg.engine(max_batch=2, cache_len=64, page_size=8)
    with FaultPlan([Fault("pool.alloc", at=0)]) as p:
        eng.run(cc.requests(pkg, n=2, max_new=3))
    assert p.fired == [("pool.alloc", 0)]
    assert np.sum(list(eng.rejections.values())) >= 1
    eng.check()
