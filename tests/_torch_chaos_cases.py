"""The chaos scenarios of ``tests/test_chaos.py`` and the two guarded
cases of ``tests/test_spec_decode.py``, written once over a package
adapter so that the same code drives the JAX ``PagedEngine`` (in the
child process of ``_torch_jax_ref.py``, mode ``chaos``) and the port's
(in ``tests/test_torch_chaos.py``).  Each case returns a JSON-able dict —
token streams, the plan's ``fired`` log, typed errors and rejections,
``stats()`` counters, fallback counters — which the port's test requires
equal to JAX's, key for key.
"""
from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace
from typing import Callable

import numpy as np

SEED = 0

# the JAX chaos suite's two engine shapes: SHARED exercises prefix sharing
# and the suffix prefill on a roomy pool; PRESSURE forces decode page
# faults, prefix eviction and preemption on a pool too small for two
# requests
SHARED = dict(max_batch=2, cache_len=64, page_size=8)
PRESSURE = dict(max_batch=2, cache_len=64, page_size=4, num_pages=7, watermark=1)
SPEC_SHAPE = dict(max_slots=2, cache_len=64, page_size=8)

#: stats() counters held equal to JAX's in every case
CHAOS_STATS = ("kernel_fallbacks", "quarantined_pages", "degrade_requeues", "preempted",
               "swap_dropped", "failed", "rejected", "prefix_hit_tokens", "cow_copies",
               "spec_rounds", "spec_rollbacks", "spec_rollback_pages")

EXHAUSTION_ATS = (0, 1, 2, 4)
CHUNKS = {"one-shot": None, "chunked4": 4}
MATRIX = {
    "swap-drop": [("swap.drop", dict(at=0))],
    "evict-refused": [("sched.evict", dict(at=0, count=2))],
    "alloc-burst": [("pool.alloc", dict(at=5, count=2))],
    "seeded-mix": [("pool.alloc", dict(prob=0.15)), ("swap.drop", dict(prob=0.25))],
}


def jax_package():
    """The adapter over the JAX package (child process only)."""
    import jax

    from repro import kernels
    from repro.configs import get_config
    from repro.models import lm
    from repro.serve import (MAX_DEGRADE_REQUEUES, Fault, FaultPlan, InjectedFault,
                             PagedEngine, PagePool, Rejected, Request, Scheduler, ServeConfig)

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = lm.init(cfg, jax.random.PRNGKey(SEED))

    def rot_blob(data):
        leaves, treedef = jax.tree.flatten(data)
        leaves[0] = np.array(leaves[0])
        leaves[0].reshape(-1)[0] = 100
        return jax.tree.unflatten(treedef, leaves)

    return SimpleNamespace(
        cfg=cfg, params=params, kernels=kernels, Fault=Fault, FaultPlan=FaultPlan,
        InjectedFault=InjectedFault, PagePool=PagePool, Rejected=Rejected, Request=Request,
        Scheduler=Scheduler, ServeConfig=ServeConfig, MAX_DEGRADE_REQUEUES=MAX_DEGRADE_REQUEUES,
        engine=lambda **kw: PagedEngine(cfg, params, **kw), rot_blob=rot_blob)


def torch_package(params):
    """The adapter over the port, on ``device="cpu"`` with ``params``
    (converted from JAX's by ``repro_torch.weights``)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serve import (MAX_DEGRADE_REQUEUES, Fault, FaultPlan, InjectedFault,
                                   PagedEngine, PagePool, Rejected, Request, Scheduler,
                                   ServeConfig)

    cfg = get_config("qwen1.5-0.5b", reduced=True)

    def rot_blob(data):
        data[0][0].reshape(-1)[0] = 100  # layer 0's K pages: one host value
        return data

    return SimpleNamespace(
        cfg=cfg, params=params, kernels=kernels, Fault=Fault, FaultPlan=FaultPlan,
        InjectedFault=InjectedFault, PagePool=PagePool, Rejected=Rejected, Request=Request,
        Scheduler=Scheduler, ServeConfig=ServeConfig, MAX_DEGRADE_REQUEUES=MAX_DEGRADE_REQUEUES,
        engine=lambda **kw: PagedEngine(cfg, params, device="cpu", **kw), rot_blob=rot_blob)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def requests(pkg, *, shared_prefix=0, n=4, max_new=5, seed=7):
    rng = np.random.default_rng(seed)
    prefix = list(rng.integers(0, pkg.cfg.vocab, size=shared_prefix))
    return [pkg.Request(rid=i, prompt=[int(t) for t in
                                       prefix + list(rng.integers(0, pkg.cfg.vocab, size=3 + i))],
                        max_new=max_new)
            for i in range(n)]


def workload(pkg, shape):
    if shape is SHARED:
        return requests(pkg, shared_prefix=32, n=4, max_new=5, seed=7)
    return requests(pkg, n=3, max_new=10, seed=3)


def plan_of(pkg, spec, seed=0):
    return pkg.FaultPlan([pkg.Fault(site, **kw) for site, kw in spec], seed=seed)


def streams(done) -> dict[str, list[int]]:
    return {str(r.rid): [int(t) for t in r.out] for r in done}


def summary(eng, done, plan=None) -> dict:
    st = eng.stats()
    return {"out": streams(done),
            "fired": [list(f) for f in plan.fired] if plan is not None else [],
            "failed": [[r.rid, r.error] for r in eng.failed],
            "stats": {k: st[k] for k in CHAOS_STATS}}


def fallback_counters(pkg) -> dict:
    return dataclasses.asdict(pkg.kernels.fallback_stats())


def run(pkg, shape, chunk, plan=None, **engine_kw) -> dict:
    """The shape's workload under ``plan`` (if any), audited."""
    eng = pkg.engine(prefill_chunk=chunk, **shape, **engine_kw)
    if plan is None:
        done = eng.run(workload(pkg, shape))
    else:
        with plan:
            done = eng.run(workload(pkg, shape))
    eng.check()
    return summary(eng, done, plan)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def baseline(pkg, shape_name, chunk):
    return run(pkg, {"shared": SHARED, "pressure": PRESSURE}[shape_name], chunk)


def pool_exhaustion(pkg, chunk, at):
    return run(pkg, SHARED, chunk, plan_of(pkg, [("pool.alloc", dict(at=at))]), kv_guard=True)


def fault_matrix(pkg, chunk, spec):
    return run(pkg, PRESSURE, chunk, plan_of(pkg, MATRIX[spec], seed=11), kv_guard=True)


def swap_blob_checksum(pkg):
    """A swap blob whose bytes rot on the host fails its checksum at
    swap-in; the request replays from its tokens."""
    reqs = requests(pkg, n=2, max_new=4)
    want = streams(pkg.engine(**SHARED).run(requests(pkg, n=2, max_new=4)))
    eng = pkg.engine(kv_guard=True, **SHARED)
    assert eng._admit(reqs[0]) is True and eng._admit(reqs[1]) is True
    eng._preempt(1)
    data, *rest = reqs[1]._swap
    reqs[1]._swap = (pkg.rot_blob(data), *rest)
    out = summary(eng, eng.run([]))
    eng.check()
    return dict(out, want=want, swap_dropped=eng.n_swap_dropped)


def corrupt_chain(pkg, chunk):
    return run(pkg, SHARED, chunk, plan_of(pkg, [("page.corrupt", dict(at=0, page_index=0))]),
               kv_guard=True)


def manual_corruption(pkg):
    """Corruption of an idle cached chain between requests: the guarded
    engine quarantines at the next match, the unguarded one shares it."""
    solo = streams(pkg.engine(**SHARED).run(requests(pkg, shared_prefix=32, n=2,
                                                     max_new=4)[1:]))
    out = {"solo": solo}
    for guard_on in (True, False):
        reqs = requests(pkg, shared_prefix=32, n=2, max_new=4)
        eng = pkg.engine(kv_guard=guard_on, **SHARED)
        eng.run([reqs[0]])  # caches the prefix chain
        eng._corrupt_page(next(iter(eng.prefix.root.children.values())).page_id)
        done = eng.run([reqs[1]])
        eng.check()
        out[f"guard={guard_on}"] = summary(eng, done)
    return out


def requeue_cap(pkg):
    """A request that keeps degrading fails with a typed error."""
    reqs = requests(pkg, shared_prefix=32, n=2, max_new=4)
    eng = pkg.engine(kv_guard=True, **SHARED)
    assert eng._admit(reqs[0]) is True
    reqs[0]._requeues = pkg.MAX_DEGRADE_REQUEUES  # at the cap already
    eng._corrupt_page(next(iter(eng.prefix.root.children.values())).page_id)
    admitted = eng._admit(reqs[1]) is True  # detects, quarantines, runs cold
    failed = [[r.rid, r.error] for r in eng.failed]
    requeued = len(eng._requeue)
    out = summary(eng, eng.run([]))
    eng.check()
    return dict(out, admitted=admitted, failed_at_admission=failed, requeued=requeued)


def kernel_raise(pkg, chunk):
    pkg.kernels.reset_fallback_stats()
    out = run(pkg, SHARED, chunk, plan_of(pkg, [("kernel.raise", dict(at=2))]),
              kernel_fallback=True)
    return dict(out, fallback=fallback_counters(pkg))


def kernel_nan(pkg):
    pkg.kernels.reset_fallback_stats()
    out = run(pkg, SHARED, None, plan_of(pkg, [("kernel.nan", dict(at=1))]),
              kernel_fallback=True)
    return dict(out, fallback=fallback_counters(pkg))


def kernel_raise_unguarded(pkg):
    eng = pkg.engine(**SHARED)
    with pkg.FaultPlan([pkg.Fault("kernel.raise", at=0)]) as plan:
        try:
            eng.run(requests(pkg, n=2, max_new=3))
        except pkg.InjectedFault as e:
            return {"error": type(e).__name__, "message": str(e),
                    "fired": [list(f) for f in plan.fired]}
    return {"error": None}


def rejected_admission(pkg):
    """A watermark rejection after a prefix match unwinds every
    reference it took."""
    reqs = requests(pkg, shared_prefix=32, n=2, max_new=5)
    # 7 usable pages: req 0 takes 5, leaving 2 — req 1 (1 fresh page after
    # matching 4 prefix pages) would breach watermark 2
    eng = pkg.engine(max_batch=2, cache_len=64, page_size=8, num_pages=8, watermark=2,
                     kv_guard=True)
    assert eng._admit(reqs[0]) is True
    before = list(eng.pool._ref)
    rej = eng._admit(reqs[1])
    eng.check()
    return {"reason": rej.reason, "retry_after_pages": rej.retry_after_pages,
            "typed": isinstance(rej, pkg.Rejected), "refs_unchanged": eng.pool._ref == before,
            "rejections": dict(eng.rejections)}


def no_free_slot(pkg):
    eng = pkg.engine(max_batch=1, cache_len=64, page_size=16)
    reqs = requests(pkg, n=2, max_new=3)
    assert eng._admit(reqs[0]) is True
    rej = eng._admit(reqs[1])
    out = {"reason": rej.reason, "retry_after_pages": rej.retry_after_pages,
           "typed": isinstance(rej, pkg.Rejected)}
    done = eng.run([reqs[1]])  # drains both; the slot frees, req 1 admits
    eng.check()
    return dict(out, **summary(eng, done))


def guards_on(pkg):
    return run(pkg, SHARED, None, kv_guard=True, kernel_fallback=True)


def spec_rollback_under_guard(pkg):
    """Tiny pages: nearly every verify round allocates a page its rejected
    tail then releases, under kv_guard."""
    out = {}
    for name, kw in (("plain", {}), ("spec", dict(spec_k=4, draft_model="ngram",
                                                   kv_guard=True))):
        eng = pkg.engine(config=pkg.ServeConfig(max_slots=2, cache_len=64, page_size=4, **kw))
        done = eng.run(requests(pkg, n=3, max_new=10, seed=3))
        eng.check()
        st = eng.stats()
        out[name] = dict(summary(eng, done), allocated_minus_freed=st["pool"]["allocated"]
                         - st["pool"]["freed"], prefix_pages=st["prefix_pages"])
    return out


def spec_cow_fault_mid_verify(pkg):
    """An injected COW failure on the allocation a verify burst needs (a
    forked child's shared tail page): absorbed by make-room-and-retry."""
    out = {}
    for name, spec in (("baseline", None), ("faulted", [("pool.cow", dict(at=0))])):
        eng = pkg.engine(config=pkg.ServeConfig(spec_k=3, draft_model="ngram", kv_guard=True,
                                                **SPEC_SHAPE))
        parent = pkg.Request(rid=0, prompt=[5, 9, 2, 7, 11, 3], max_new=8)
        assert eng._admit(parent)
        assert eng.fork(0, pkg.Request(rid=1, prompt=[5, 9, 2, 7, 11, 3], max_new=8)) is not None
        plan = plan_of(pkg, spec) if spec else None
        done = {}
        with plan or contextlib.nullcontext():
            while len(done) < 2:
                for r in eng.step():
                    done[str(r.rid)] = [int(t) for t in r.out]
        eng.check()
        st = eng.stats()
        out[name] = {"out": done, "fired": [list(f) for f in plan.fired] if plan else [],
                     "cow": eng.n_cow, "stats": {k: st[k] for k in CHAOS_STATS}}
    return out


def cases() -> dict[str, Callable]:
    """Every case by name: ``fn(pkg) -> dict``."""
    out: dict[str, Callable] = {}
    for shape in ("shared", "pressure"):
        for cid, chunk in CHUNKS.items():
            out[f"baseline-{shape}-{cid}"] = lambda p, s=shape, c=chunk: baseline(p, s, c)
    for cid, chunk in CHUNKS.items():
        for at in EXHAUSTION_ATS:
            out[f"exhaustion-{cid}-{at}"] = lambda p, c=chunk, a=at: pool_exhaustion(p, c, a)
        for spec in MATRIX:
            out[f"matrix-{cid}-{spec}"] = lambda p, c=chunk, s=spec: fault_matrix(p, c, s)
        out[f"corrupt-chain-{cid}"] = lambda p, c=chunk: corrupt_chain(p, c)
        out[f"kernel-raise-{cid}"] = lambda p, c=chunk: kernel_raise(p, c)
    out.update({
        "swap-blob-checksum": swap_blob_checksum,
        "manual-corruption": manual_corruption,
        "requeue-cap": requeue_cap,
        "kernel-nan": kernel_nan,
        "kernel-raise-unguarded": kernel_raise_unguarded,
        "rejected-admission": rejected_admission,
        "no-free-slot": no_free_slot,
        "guards-on": guards_on,
        "spec-rollback-under-guard": spec_rollback_under_guard,
        "spec-cow-fault-mid-verify": spec_cow_fault_mid_verify,
    })
    return out
