"""The port's dispatch layer (``kernels/api.py``, ``kernels/autotune.py``)
against the JAX package's: the same policy syntax, and the same schedule
picked for every (shape, dtype, policy) of a grid that covers the
serving shapes, the exact tie at M <= 2048 (``tiled`` listed first
wins) and the one shape where ``mcast`` is cheaper (M = 2049), and the
grouped expert matmuls of ``grouped_linear`` at moonshot-v1-16b-a3b's
shapes.  A forced
matmul schedule cannot reach paged attention in either package, and the
``reference`` policies resolve as JAX's (``tests/test_torch_reference.py``
holds the reference backend itself).

Both registries run in this process; nothing executes a kernel except
the paged-engine run, which uses the plain CPU path."""
import dataclasses
import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import SEED
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.kernels import api as jax_api
from repro.models import lm as jax_lm
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import api
from repro_torch.models import lm as lm_port
from repro_torch.serve import PagedEngine, Request, ServeConfig
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _autotune_cache(tmp_path, monkeypatch):
    """JAX's ``resolve`` consults its autotune cache: keep it per test."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.mark.parametrize("text", ["tiled", "mcast", "backend=pallas",
                                  "schedule=unicast,autotune=off", "", "reference",
                                  "backend=pallas,autotune=0"])
def test_policy_parse_matches_jax_field_by_field(text):
    """Every field the port keeps parses as JAX's does; JAX's ``autotune``
    is accepted and dropped (the CUDA kernels' tiles are fixed)."""
    want = dataclasses.asdict(jax_api.DispatchPolicy.parse(text))
    got = dataclasses.asdict(api.DispatchPolicy.parse(text))
    assert got == {field: want[field] for field in got}
    assert set(want) - set(got) == {"autotune"}


def test_policy_parse_rejects_what_jax_rejects():
    for bad in ("colour=red", "backend=tpu"):
        with pytest.raises(ValueError):
            jax_api.DispatchPolicy.parse(bad)
        with pytest.raises(ValueError):
            api.DispatchPolicy.parse(bad)


MS = (1, 4, 48, 256, 2048, 2049, 4096)
KNS = ((1024, 1024), (1024, 2816), (2816, 1024))
POLICIES = (None, "tiled", "mcast", "unicast", "backend=pallas,autotune=off")
GRID = [(m, k, n, dt) for m, (k, n), dt in itertools.product(MS, KNS, ("bfloat16", "float32"))]
GRID += [(m, 1024, 151936, "float32") for m in (1, 4, 48)]  # the tied fp32 logits


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_resolve_picks_the_jax_schedule_over_the_grid(policy):
    """The port's default is the JAX package's default on a TPU:
    ``backend=pallas``, cheapest available schedule."""
    jax_policy = policy or "backend=pallas"
    torch_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for m, k, n, dt in GRID:
        want = jax_kernels.resolve("matmul", (m, k, n), dt, jax_policy).schedule
        got = kernels.resolve("matmul", (m, k, n), torch_dtype[dt], policy)
        assert got.schedule == want, (m, k, n, dt, policy)
        assert got.backend == "pallas"
    if policy is None:  # the two sides of the M = 2048 tie
        assert kernels.resolve("matmul", (2049, 1024, 2816), torch.bfloat16).schedule == "mcast"
        assert kernels.resolve("matmul", (2048, 1024, 2816), torch.bfloat16).schedule == "tiled"


def test_resolve_follows_set_policy_and_the_environment(monkeypatch):
    shape = (4, 1024, 1024)
    assert kernels.resolve("matmul", shape, torch.bfloat16).schedule == "tiled"
    monkeypatch.setenv(api.POLICY_ENV_VAR, "unicast")
    assert kernels.resolve("matmul", shape, torch.bfloat16).schedule == "unicast"
    with kernels.use_policy("mcast"):  # global beats the environment
        assert kernels.resolve("matmul", shape, torch.bfloat16).schedule == "mcast"
        # and a per-call policy beats both
        assert kernels.resolve("matmul", shape, torch.bfloat16, "tiled").schedule == "tiled"
    assert kernels.get_policy() == api.DispatchPolicy(schedule="unicast")
    monkeypatch.setenv(api.POLICY_ENV_VAR, "mcast")  # a memoised pick follows a new value
    assert kernels.resolve("matmul", shape, torch.bfloat16).schedule == "mcast"


@pytest.mark.parametrize("shape", [
    (4, 1, 16, 16, 16, 16, 64, 0),   # decode
    (1, 16, 16, 16, 16, 16, 64, 0),  # suffix prefill
    (1, 5, 16, 4, 16, 16, 64, 0),    # ragged suffix, GQA
    (2, 1, 16, 16, 16, 16, 64, 2),   # int8 pools
])
@pytest.mark.parametrize("policy", [None, "pallas_prefill"], ids=str)
def test_paged_attention_resolve_matches_jax(shape, policy):
    want = jax_kernels.resolve("paged_attention", shape, "bfloat16",
                               policy or "backend=pallas").schedule
    assert kernels.resolve("paged_attention", shape, torch.bfloat16, policy).schedule == want


@pytest.mark.parametrize("schedule", ["mcast", "unicast", "tiled"])
def test_forced_matmul_schedule_cannot_reach_paged_attention(schedule):
    shape = (4, 1, 16, 16, 16, 16, 64, 0)
    msg = f"kernel op 'paged_attention' has no schedule '{schedule}'"
    with pytest.raises(ValueError, match=msg):
        jax_kernels.resolve("paged_attention", shape, "bfloat16", schedule)
    with pytest.raises(ValueError, match=msg):
        kernels.resolve("paged_attention", shape, torch.bfloat16, schedule)


def test_forced_mcast_on_the_paged_engine_raises():
    """``--kv paged --kernel-policy mcast`` fails in the JAX launcher with
    this ValueError; the port's engine fails the same way."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    eng = PagedEngine(cfg, params, device="cpu",
                      config=ServeConfig(max_slots=2, cache_len=64, page_size=8))
    with kernels.use_policy("mcast"), \
            pytest.raises(ValueError, match="kernel op 'paged_attention' has no schedule 'mcast'"):
        eng.run([Request(rid=0, prompt=list(range(1, 12)), max_new=2)])


@pytest.mark.parametrize("policy", ["backend=reference", "reference", "schedule=reference"])
def test_reference_backend_is_not_ported(policy):
    """Once refused, now ported: each spelling of the reference policy
    resolves to JAX's ``reference`` schedule, and ``linear`` under it runs
    the oracle — JAX's values, the product's own dtype (fp32 here, where
    the kernels would return ``x.dtype``) — launching no kernel."""
    want = jax_kernels.resolve("matmul", (4, 64, 64), "bfloat16", policy)
    got = kernels.resolve("matmul", (4, 64, 64), torch.bfloat16, policy)
    assert (got.schedule, got.backend, got.vjp) == (want.schedule, want.backend, want.vjp) \
        == ("reference", "reference", True)
    rng = np.random.default_rng(5)
    x, w = rng.standard_normal((2, 8)).astype(np.float32), rng.standard_normal((8, 4))
    w = jnp.asarray(w, jnp.bfloat16)
    with jax_kernels.use_policy(policy):
        ref = np.asarray(jax_kernels.linear(jnp.asarray(x), w))
    kernels.reset_launch_counts()
    with kernels.use_policy(policy):
        out = kernels.linear(torch.from_numpy(x), torch.from_numpy(np.asarray(w, np.float32))
                             .to(torch.bfloat16))
    assert out.dtype == torch.float32 and str(ref.dtype) == "float32"
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_unknown_schedule_raises_like_jax():
    with pytest.raises(ValueError, match="has no schedule 'split_k'"):
        kernels.resolve("matmul", (4, 64, 64), torch.bfloat16, "split_k")
    with pytest.raises(ValueError, match="unknown kernel op"):
        kernels.op("conv2d")


def test_autotune_candidates_match_jax():
    """The copied selection model: same configs, budgets and costs."""
    from repro.kernels import autotune as jax_autotune
    from repro_torch.kernels import autotune

    for sched, shape in (("mcast", (2049, 1024, 2816)), ("tiled", (4, 1024, 151936)),
                         ("unicast", (48, 2816, 1024))):
        for dt in ("bfloat16", "float32"):
            want = jax_autotune.candidates("matmul", shape, dt, schedule=sched)
            got = autotune.candidates("matmul", shape, dt, schedule=sched)
            assert [(c.config, c.vmem_bytes, c.grid_steps, c.hbm_bytes) for c in got] == \
                [(c.config, c.vmem_bytes, c.grid_steps, c.hbm_bytes) for c in want]
    assert autotune.VMEM_BUDGET == jax_autotune.VMEM_BUDGET
    assert autotune.STEP_OVERHEAD_BYTES == jax_autotune.STEP_OVERHEAD_BYTES


# ---------------------------------------------------------------------------
# the scan families: ssd and rglru
# ---------------------------------------------------------------------------

# the JAX dispatch tests' shapes, a ragged SSD sequence and a long RG-LRU one
SCAN_SHAPES = [("ssd", (1, 2, 256, 64, 64)), ("ssd", (2, 48, 2048, 64, 128)),
               ("ssd", (1, 3, 200, 32, 16)), ("rglru", (1, 256, 256)),
               ("rglru", (2, 2048, 2560)), ("rglru", (3, 77, 192))]


@pytest.mark.parametrize("name,shape", SCAN_SHAPES, ids=str)
@pytest.mark.parametrize("policy", [None, "backend=pallas", "pallas"], ids=str)
@pytest.mark.parametrize("needs_vjp", [False, True])
def test_scan_resolve_matches_jax(name, shape, policy, needs_vjp):
    want = jax_kernels.resolve(name, shape, "float32", policy or "backend=pallas",
                               needs_vjp=needs_vjp)
    got = kernels.resolve(name, shape, torch.float32, policy, needs_vjp=needs_vjp)
    assert (got.schedule, got.backend, got.vjp) == (want.schedule, want.backend, want.vjp)


@pytest.mark.parametrize("name,shape", [
    ("ssd", (1, 1, 256, 2048, 2048)),  # a 16 MB (P, N) state: over the VMEM budget
    ("rglru", (1, 4099, 256)),         # a prime sequence: one 4099-step block overflows
])
@pytest.mark.parametrize("needs_vjp", [False, True])
def test_scan_dispatch_diverges_from_jax_where_the_tpu_blocks_do_not_fit(
        monkeypatch, name, shape, needs_vjp):
    """The documented divergence: JAX's auto-dispatch on a TPU (its
    default backend ``pallas``, here by declaring the interpreter off)
    finds its kernel unavailable and picks the reference backend; the
    port's kernels tile the state and walk any length, so it picks its
    kernel.  At every other shape the two agree (above)."""
    monkeypatch.setattr(jax_api, "_interpret", lambda: False)
    assert not jax_api.op(name).schedule("pallas").available(jax_api.Problem(shape, "float32"))
    want = jax_kernels.resolve(name, shape, "float32", needs_vjp=needs_vjp)
    assert (want.schedule, want.backend) == ("reference", "reference")
    got = kernels.resolve(name, shape, torch.float32, needs_vjp=needs_vjp)
    assert (got.schedule, got.backend, got.vjp) == ("pallas", "pallas", True)
    for tidy in [s for n, s in SCAN_SHAPES if n == name]:  # a TPU agrees elsewhere
        assert jax_kernels.resolve(name, tidy, "float32", needs_vjp=needs_vjp).schedule == \
            kernels.resolve(name, tidy, torch.float32, needs_vjp=needs_vjp).schedule == "pallas"


@pytest.mark.parametrize("kernel,shapes", [
    ("ssd", [(1, 2, 384, 64, 32), (2, 48, 2048, 64, 128), (1, 3, 200, 32, 16)]),
    ("rglru", [(2, 384, 256), (2, 2048, 2560), (3, 77, 192)]),
    ("flash_attention", [(2, 16, 2048, 2048, 64), (3, 8, 77, 200, 128)]),
])
def test_scan_and_flash_candidates_match_jax(kernel, shapes):
    """The copied forward candidates of the ssd, rglru and flash families
    (the lone schedule's cost): same configs, working sets and costs."""
    from repro.kernels import autotune as jax_autotune
    from repro_torch.kernels import autotune

    for shape in shapes:
        for dt in ("bfloat16", "float32"):
            want = jax_autotune.candidates(kernel, shape, dt)
            got = autotune.candidates(kernel, shape, dt)
            assert [(c.config, c.vmem_bytes, c.grid_steps, c.cost) for c in got] == \
                [(c.config, c.vmem_bytes, c.grid_steps, c.cost) for c in want], (kernel, shape)


# qwen1.5-1.8b at full width (d 2048, d_ff 5504, vocab 151,936, untied):
# its decode (4 rows) and verify (4 x (k + 1) = 20 rows) projections, its
# fp32 logits against the (d, vocab) head, and its draft qwen1.5-0.5b's
# decode shapes; and its paged attention (16 heads of 128, page 16, 16
# pages a sequence) at decode and verify, over bf16 and int8 pools
PAIR_MATMULS = [(m, k, n, "bfloat16") for m in (4, 20, 48)
                for k, n in ((2048, 2048), (2048, 5504), (5504, 2048))]
PAIR_MATMULS += [(m, 2048, 151936, "float32") for m in (1, 4, 20)]
PAIR_MATMULS += [(4, 1024, 1024, "bfloat16"), (4, 1024, 2816, "bfloat16"),
                 (4, 1024, 151936, "float32")]
PAIR_PAGED = [(4, s, 16, 16, 16, 16, 128, scales) for s in (1, 5) for scales in (0, 2)]


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_resolve_picks_the_jax_schedule_at_the_speculative_pairs_shapes(policy):
    torch_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for m, k, n, dt in PAIR_MATMULS:
        want = jax_kernels.resolve("matmul", (m, k, n), dt, policy or "backend=pallas")
        got = kernels.resolve("matmul", (m, k, n), torch_dtype[dt], policy)
        assert got.schedule == want.schedule, (m, k, n, dt, policy)
    for shape in PAIR_PAGED:
        if policy in (None, "backend=pallas,autotune=off"):
            want = jax_kernels.resolve("paged_attention", shape, "bfloat16",
                                       policy or "backend=pallas").schedule
            assert kernels.resolve("paged_attention", shape, torch.bfloat16,
                                   policy).schedule == want, shape
    if policy is None:  # int8 pools and verify bursts run K3, bf16 decode K2
        picks = {s: kernels.resolve("paged_attention", s, torch.bfloat16).schedule
                 for s in PAIR_PAGED}
        assert picks == {s: "pallas" if s[1] == 1 and s[-1] == 0 else "pallas_prefill"
                         for s in PAIR_PAGED}


def test_untied_logits_dispatch_keys_the_problem_as_jax_does():
    """The untied head's call reaches dispatch as JAX's does: the
    flattened (tokens, d, vocab) problem keyed on the fp32 activations
    (JAX widens the bf16 head to fp32; the port's B stays bf16 and is
    not part of the key), and both pick the same schedule."""
    from _torch_jax_ref import TARGET, untied_config

    cfg = untied_config(get_config(TARGET, reduced=True))
    params = lm_port.init(cfg, seed=0, device="cpu")
    seen = []
    pick = api._pick.__wrapped__

    def spy(name, problem, pol, needs_vjp):
        seen.append((name, problem))
        return pick(name, problem, pol, needs_vjp)

    api._pick.cache_clear()
    with mock.patch.object(api, "_pick", spy):
        lm_port.forward(params, cfg, torch.zeros((2, 5), dtype=torch.long))
    logits = [p for name, p in seen if name == "matmul" and p.shape[2] == cfg.vocab]
    assert logits == [api.Problem((10, cfg.d_model, cfg.vocab), "float32")]
    want = jax_kernels.resolve("matmul", logits[0].shape, "float32", "backend=pallas")
    assert kernels.resolve("matmul", logits[0].shape, torch.float32).schedule == want.schedule


#: grouped problems: the moonshot experts at full width (decode: 4
#: sequences x top-6 = 24 rows; a 512-token prefill: capacity 60; 2
#: prompts of 512 tokens: 120 rows) and the reduced config's
GROUPED_SHAPES = [((), 64, 24, 2048, 1408), ((), 64, 24, 1408, 2048), ((), 64, 60, 2048, 1408),
                  ((2,), 64, 60, 2048, 1408), ((4,), 8, 2, 64, 32), ((2,), 8, 24, 64, 32)]


@pytest.mark.parametrize("policy", [None, "tiled", "mcast", "unicast", "backend=pallas"],
                         ids=str)
def test_grouped_linear_resolves_the_jax_schedule(policy):
    """Each side's ``grouped_linear`` (the MoE expert matmuls) reaches the
    same matmul schedule: JAX's vmapped ``linear`` traced (no kernel runs)
    with its ``_invoke`` recorded, the port's on meta tensors with its
    wrappers recorded; one kernel call each, for all groups."""
    jax_policy = policy or "backend=pallas"
    for lead, g, m, k, n in GROUPED_SHAPES:
        seen = []
        real = jax_api._invoke

        def record(name, sched, *args, **kw):
            seen.append(sched.name)
            return real(name, sched, *args, **kw)

        with mock.patch.object(jax_api, "_invoke", record):
            jax.eval_shape(lambda x, w: jax_api.grouped_linear(x, w, policy=jax_policy),
                           jax.ShapeDtypeStruct((*lead, g, m, k), jnp.bfloat16),
                           jax.ShapeDtypeStruct((g, k, n), jnp.bfloat16))
        reached = []

        def fake(name):
            def run(a, b, *rest, **kw):
                reached.append(name)
                return torch.empty((*a.shape[:-1], b.shape[-1]), dtype=a.dtype, device="meta")
            return run

        with mock.patch.object(api, "matmul_tiled", fake("tiled")), \
                mock.patch.object(api, "matmul_mcast", fake("mcast")), \
                mock.patch.object(api, "matmul_unicast", fake("unicast")):
            y = kernels.grouped_linear(torch.empty((*lead, g, m, k), dtype=torch.bfloat16,
                                                   device="meta"),
                                       torch.empty((g, k, n), dtype=torch.bfloat16,
                                                   device="meta"), policy=policy)
        assert y.shape == (*lead, g, m, n)
        assert seen == reached and len(reached) == 1, ((lead, g, m, k, n), seen, reached)
