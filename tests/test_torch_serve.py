"""The port's ``PagedEngine`` on ``device="cpu"`` against the JAX
``PagedEngine``: token-identical greedy streams on the same seeded
requests and the same converted parameters, for a shared-prefix run, the
same run with chunked prefill, and a small pool that forces preemption;
the pool audit after every run; the launcher's stdout against the JAX
launcher's.

The JAX side runs in a child process with every kernel under the Pallas
backend and XLA's excess precision off (``_torch_jax_ref.py``).  The two
sides agree to fp32 summation order, which is what greedy streams need
unless two logits tie within that round-off."""
import contextlib
import io
import json

import jax
import pytest
import torch

from _torch_jax_ref import LAUNCH_ARGS, SEED, SERVE_RUNS, params_checksum, serve_requests
from _torch_util import jax_reference
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.serve import GuardViolation, PagedEngine, Request, ServeConfig
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = jax_reference("serve", tmp_path_factory.mktemp("jax_serve"))
    assert float(out["params_checksum"]) == params_checksum(model[1])
    return json.loads(str(out["serve_json"]))


def _requests(**kw):
    return [Request(rid=r, prompt=p, max_new=m) for r, p, m in serve_requests(**kw)]


@pytest.mark.parametrize("run", sorted(SERVE_RUNS))
def test_streams_token_identical_to_jax_engine(model, ref, run):
    cfg, _, params = model
    req_kw, eng_kw = SERVE_RUNS[run]
    eng = PagedEngine(cfg, params, device="cpu", **eng_kw)
    done = eng.run(_requests(**req_kw))
    eng.check()  # refcount / free-list audit: nothing leaked by the run
    assert {str(r.rid): r.out for r in done} == ref[run]["out"]
    assert all(len(r.out) == r.max_new for r in done)
    st = eng.stats()
    for key, val in ref[run]["stats"].items():
        assert st[key] == val, key
    if run == "preempt":
        assert st["preempted"] > 0
    else:
        assert st["prefix_hit_tokens"] > 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # plain path


def test_launcher_stdout_matches_jax_launcher(model, ref):
    """``python -m repro_torch.launch.serve`` prints the JAX launcher's
    ``req …`` lines for the same flags and weights."""
    _, _, params = model
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        launcher.main([*LAUNCH_ARGS, "--device", "cpu"], params=params)
    want = ref["launcher_stdout"].splitlines()
    assert [ln for ln in want if ln.startswith("req ")]  # six request lines to diff
    assert buf.getvalue().splitlines() == want


def test_fork_copy_on_write_keeps_parent_and_child_exact(model):
    """A fork shares every parent page; the first divergent write copies
    the shared tail page and leaves the parent's bytes untouched."""
    cfg, _, params = model
    eng = PagedEngine(cfg, params, device="cpu", max_batch=2, cache_len=64, page_size=8)
    parent = Request(rid=0, prompt=list(range(1, 13)), max_new=6)
    assert eng._admit(parent) is True
    eng.step()
    tail = eng.slots[0].pages[-1]
    before = [c.k_pages[:, tail].clone() for c in eng.caches]
    child = Request(rid=1, prompt=parent.prompt, max_new=6)
    cslot = eng.fork(0, child)
    assert eng.slots[cslot].pages == eng.slots[0].pages
    eng.step()
    assert eng.n_cow == 1 and eng.slots[cslot].pages[-1] != eng.slots[0].pages[-1]
    assert child.out == parent.out  # greedy: the fork continues identically
    rows = slice(0, 5)  # positions 8..12, written before the fork
    for c, b in zip(eng.caches, before):  # the copy and the original agree
        assert torch.equal(c.k_pages[:, eng.slots[0].pages[-1], rows], b[:, rows])
        assert torch.equal(c.k_pages[:, tail, rows], b[:, rows])
    eng.check()


def test_check_catches_a_leaked_page(model):
    cfg, _, params = model
    eng = PagedEngine(cfg, params, device="cpu", max_batch=2, cache_len=64, page_size=8)
    eng.run(_requests(n=2, max_new=3))
    eng.pool.alloc(1)  # a page nobody holds
    with pytest.raises(GuardViolation):
        eng.check()


@pytest.mark.parametrize("option", [
    dict(kv_dtype="int8"), dict(spec_k=2, draft_model="ngram"), dict(num_shards=2),
    dict(kv_guard=True), dict(kernel_fallback=True), dict(chaos=("pool.alloc",)),
])
def test_unported_options_raise_naming_the_option(model, option):
    cfg, _, params = model
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        PagedEngine(cfg, params, device="cpu", config=ServeConfig(**option))


def test_armed_fault_plan_raises(model):
    from repro_torch.serve.faults import Fault, FaultPlan

    cfg, _, params = model
    eng = PagedEngine(cfg, params, device="cpu", max_batch=2, cache_len=64, page_size=8)
    with FaultPlan([Fault("pool.alloc")]), pytest.raises(NotImplementedError, match="fault"):
        eng.run(_requests(n=1))
