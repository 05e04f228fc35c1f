"""The port's ``reference`` backend against the JAX package's.

* Each family's ``reference`` schedule — matmul (``linear`` with a bias
  and every activation, and the 2-D ``op("matmul")``), flash attention,
  paged attention on bf16 and int8 pools, ssd, rglru — against JAX's
  ``backend=reference`` on the same numpy-seeded inputs, in this process,
  at the per-dtype tolerances of ``_torch_util.TOL``; the output dtype
  too, which for ``linear`` is the product's own dtype (not ``x.dtype``),
  and the epilogue's rounding point (the cast before the bias add).
* Forced (``backend=reference``, ``reference``, ``schedule=reference``)
  and automatic dispatch against ``jax_kernels.resolve``, including
  paged attention under differentiation, which both send to the
  reference.
* The ``FallbackStats`` counters of ``call_with_fallback`` for each
  outcome, and a primary whose error left the CUDA context unusable,
  which propagates instead of being retried.
* Greedy streams of the reduced qwen1.5-0.5b ``PagedEngine`` under the
  port's ``reference`` policy against JAX's ``PagedEngine`` on its CPU
  default, the reference backend (``_torch_jax_ref.py refserve``).  Here
  the oracle is JAX's reference backend, not ``backend=pallas``: the two
  round differently (ROADMAP Queue 3 entry 5).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import SEED, SERVE_RUNS, params_checksum, serve_requests
from _torch_util import close, jax_reference, t
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.nn.kvquant import quantize_kv
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import api
from repro_torch.serve import PagedEngine, Request
from repro_torch.weights import from_jax_params

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
POLICIES = ["backend=reference", "reference", "schedule=reference"]


def _draw(shape, dtype, seed, scale=1.0):
    """The same values on both sides: a seeded fp32 draw rounded to
    ``dtype`` once (jnp array) and converted exactly (tensor)."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * scale, JNP[dtype])
    return a, t(a)


def _jax_ref(fn):
    with jax_kernels.use_policy("reference"):
        return fn()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine runs are many tiny ops: one torch thread, so the suite's
    other workers are not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _autotune_cache(tmp_path, monkeypatch):
    """JAX's ``resolve`` consults its autotune cache: keep it per test."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


# ---------------------------------------------------------------------------
# each family's reference schedule against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "gelu_tanh", "silu", "sigmoid"])
def test_linear_reference_matches_jax(activation, policy):
    xj, x = _draw((3, 5, 32), torch.bfloat16, 0)
    wj, w = _draw((32, 24), torch.bfloat16, 1, 0.2)
    bj, b = _draw((24,), torch.bfloat16, 2)
    want = _jax_ref(lambda: jax_kernels.linear(xj, wj, bias=bj, activation=activation))
    got = kernels.linear(x, w, bias=b, activation=activation, policy=policy)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    close(got, want)
    # the epilogue's rounding point: the product rounds to bf16 before the
    # bias add, which runs in bf16 too, and so does the activation
    z = (x.float() @ w.float()).to(torch.bfloat16) + b
    assert torch.equal(got, api.REFERENCE_ACTIVATIONS[activation or "none"](z))


ACTS = ("silu", "sigmoid", "gelu", "gelu_tanh", "relu")


@pytest.fixture(scope="module")
def jax_activations():
    """JAX's activations on one bf16 draw, jitted with excess precision off
    (every bf16 op rounds, as in the serving references), in a child."""
    code = ("import numpy as np, jax, jax.numpy as jnp, sys\n"
            "from repro.kernels.matmul.matmul import _ACTIVATIONS\n"
            "y = jnp.asarray(np.random.default_rng(0).standard_normal(4096) * 3, jnp.bfloat16)\n"
            f"out = [jax.jit(_ACTIVATIONS[a])(y) for a in {ACTS!r}]\n"
            "sys.stdout.buffer.write(np.asarray(out, np.float32).tobytes())")
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          timeout=300, check=True)
    return dict(zip(ACTS, np.frombuffer(proc.stdout, np.float32).reshape(len(ACTS), -1)))


@pytest.mark.parametrize("activation", ACTS)
def test_reference_activations_round_as_jax_does(jax_activations, activation):
    """The bf16 activation of the reference epilogue, op by op as
    ``jax.nn`` composes it: bit for bit (``sigmoid`` and ``silu``, what
    the serving models run), or within a bf16 ulp (the tanh gelu)."""
    want = jax_activations[activation]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096) * 3).to(torch.bfloat16)
    got = api.REFERENCE_ACTIVATIONS[activation](y).float().numpy()
    if activation in ("silu", "sigmoid", "relu"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-8, atol=2**-8)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_linear_reference_out_dtype_is_the_products_own(out_dtype):
    """fp32 activations on a bf16 weight (the logits): the reference runs
    the product in fp32 and returns fp32 — where the kernels' default
    would be ``x.dtype`` — and contracts several dims like JAX."""
    xj, x = _draw((4, 2, 8), torch.float32, 3)
    wj, w = _draw((2, 8, 40), torch.bfloat16, 4, 0.3)
    jdt = None if out_dtype is None else jnp.float32
    want = _jax_ref(lambda: jax_kernels.linear(xj, wj, contract_dims=2, out_dtype=jdt))
    got = kernels.linear(x, w, contract_dims=2, out_dtype=out_dtype, policy="reference")
    assert got.dtype == torch.float32 and str(want.dtype) == "float32" and got.shape == (4, 40)
    close(got, want)
    xj, x = _draw((6, 16), torch.bfloat16, 5)
    want = _jax_ref(lambda: jax_kernels.linear(xj, wj.reshape(16, 40), out_dtype=jdt))
    got = kernels.linear(x, w.reshape(16, 40), out_dtype=out_dtype, policy="reference")
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    close(got, want, torch.bfloat16)


def test_matmul_op_reference_matches_jax():
    aj, a = _draw((12, 32), torch.bfloat16, 6)
    bj, b = _draw((32, 20), torch.bfloat16, 7, 0.2)
    cj, c = _draw((20,), torch.bfloat16, 8)
    want = _jax_ref(lambda: jax_kernels.op("matmul")(aj, bj, cj, activation="silu"))
    with kernels.use_policy("reference"):
        got = kernels.op("matmul")(a, b, c, activation="silu")
    assert got.dtype == torch.bfloat16
    close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", [dict(causal=True), dict(causal=False),
                                  dict(causal=True, window=7, softcap=5.0)], ids=str)
def test_flash_reference_matches_jax(dtype, opts):
    qj, q = _draw((2, 4, 24, 16), dtype, 9)
    kj, k = _draw((2, 2, 24, 16), dtype, 10)
    vj, v = _draw((2, 2, 24, 16), dtype, 11)
    want = _jax_ref(lambda: jax_kernels.op("flash_attention")(qj, kj, vj, **opts))
    with kernels.use_policy("reference"):
        got = kernels.op("flash_attention")(q, k, v, **opts)
    assert got.dtype == dtype
    close(got, want)


TABLE = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [8, 9, 0, 0]], np.int32)


@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_paged_reference_matches_jax(pool, s):
    kj, _ = _draw((2, 12, 8, 16), torch.bfloat16, 12)
    vj, _ = _draw((2, 12, 8, 16), torch.bfloat16, 13)
    qj, q = _draw((3, s, 4, 16), torch.bfloat16, 14)
    if pool == "int8":
        (kj, ksj), (vj, vsj) = quantize_kv(kj), quantize_kv(vj)
        scales_j = (ksj, vsj)
    else:
        scales_j = ()
    lengths = np.array([29, 23, 9], np.int32)
    start = lengths - s
    args_j = (qj, kj, vj, jnp.asarray(TABLE), jnp.asarray(start), jnp.asarray(lengths),
              *scales_j)
    want = _jax_ref(lambda: jax_kernels.op("paged_attention")(*args_j, softcap=None))
    with kernels.use_policy("reference"):
        got = kernels.op("paged_attention")(q, *(t(a) for a in args_j[1:]))
    assert got.dtype == torch.bfloat16 and got.shape == (3, s, 4, 16)
    close(got, want)


@pytest.mark.parametrize("shape", [(1, 2, 20, 8, 4), (2, 3, 33, 4, 8)])
def test_ssd_reference_matches_jax(shape):
    b, h, s, p, n = shape
    xj, x = _draw((b, h, s, p), torch.float32, 15)
    bj, bm = _draw((b, s, n), torch.float32, 16)
    cj, cm = _draw((b, s, n), torch.float32, 17)
    la = -np.abs(np.random.default_rng(18).standard_normal((b, h, s))).astype(np.float32) * 0.3
    want = _jax_ref(lambda: jax_kernels.op("ssd")(xj, bj, cj, jnp.asarray(la)))
    with kernels.use_policy("reference"):
        got = kernels.op("ssd")(x, bm, cm, torch.from_numpy(la))
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_reference_matches_jax(dtype):
    a_np = np.random.default_rng(19).uniform(0.5, 0.99, (2, 20, 16))
    aj = jnp.asarray(a_np, JNP[dtype])
    bj, b = _draw((2, 20, 16), dtype, 20)
    want = _jax_ref(lambda: jax_kernels.op("rglru")(aj, bj))
    with kernels.use_policy("reference"):
        got = kernels.op("rglru")(t(aj), b)
    assert got.dtype == dtype  # the oracle carries its state in a's dtype
    close(got, want)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

SHAPES = [("matmul", (4, 64, 64)), ("flash_attention", (1, 4, 64, 64, 16)),
          ("paged_attention", (2, 1, 4, 2, 4, 8, 16, 0)),
          ("paged_attention", (2, 5, 4, 2, 4, 8, 16, 2)),
          ("ssd", (1, 2, 256, 64, 64)), ("rglru", (1, 256, 256))]


@pytest.mark.parametrize("name,shape", SHAPES, ids=str)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("needs_vjp", [False, True])
def test_forced_reference_resolves_as_jax(name, shape, policy, needs_vjp):
    want = jax_kernels.resolve(name, shape, "bfloat16", policy, needs_vjp=needs_vjp)
    got = kernels.resolve(name, shape, torch.bfloat16, policy, needs_vjp=needs_vjp)
    assert (got.schedule, got.backend, got.vjp) == (want.schedule, want.backend, want.vjp) \
        == ("reference", "reference", True)


@pytest.mark.parametrize("name,shape", SHAPES, ids=str)
@pytest.mark.parametrize("needs_vjp", [False, True])
def test_auto_dispatch_resolves_as_jax_on_a_tpu(monkeypatch, name, shape, needs_vjp):
    """The port's default is JAX's on a TPU (declared here by turning its
    interpreter off): the kernels, and the reference only where no kernel
    schedule can run — paged attention under differentiation."""
    from repro.kernels import api as jax_api

    monkeypatch.setattr(jax_api, "_interpret", lambda: False)
    want = jax_kernels.resolve(name, shape, "bfloat16", needs_vjp=needs_vjp)
    got = kernels.resolve(name, shape, torch.bfloat16, needs_vjp=needs_vjp)
    assert (got.schedule, got.backend, got.vjp) == (want.schedule, want.backend, want.vjp)
    assert (got.backend == "reference") == (name == "paged_attention" and needs_vjp)


def test_forcing_a_kernel_schedule_and_the_reference_backend_raises_like_jax():
    msg = "policy forces schedule 'tiled' .* but also backend 'reference'"
    with pytest.raises(ValueError, match=msg):
        jax_kernels.resolve("matmul", (4, 64, 64), "bfloat16", "schedule=tiled,backend=reference")
    with pytest.raises(ValueError, match=msg):
        kernels.resolve("matmul", (4, 64, 64), torch.bfloat16,
                        "schedule=tiled,backend=reference")


def test_reference_schedules_launch_no_kernel():
    """Nothing of the reference path goes through a kernel wrapper."""
    kernels.reset_launch_counts()
    _, x = _draw((4, 32), torch.bfloat16, 21)
    _, w = _draw((32, 16), torch.bfloat16, 22)
    with kernels.use_policy("reference"):
        kernels.linear(x, w, activation="silu")
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


# ---------------------------------------------------------------------------
# the fallback
# ---------------------------------------------------------------------------


def test_a_lost_device_propagates_without_retry(monkeypatch):
    """A primary whose error left the CUDA context unusable (a sticky
    error: every later call fails) is not retried: the error propagates
    and no fallback is counted."""
    kernels.reset_fallback_stats()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)

    def lost():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", lost)
    retried = []

    def primary():
        raise RuntimeError("CUDA kernel paged_attention_decode failed to launch: cudaError 700")

    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernels.call_with_fallback(primary, lambda: retried.append(1))
    assert not retried
    st = kernels.fallback_stats()
    assert (st.fallbacks, st.raised) == (0, 0)


def test_fallback_stats_count_each_outcome():
    """The ``FallbackStats`` unit cases: a clean call, a raise, a failed
    check, and a reference retry that fails too (not guarded)."""
    kernels.reset_fallback_stats()
    assert kernels.call_with_fallback(lambda x: x + 1, lambda x: -1, 1) == (2, False)

    def boom(x):
        raise ValueError("bad launch")

    assert kernels.call_with_fallback(boom, lambda x: -x, 3) == (-3, True)
    nan = torch.tensor([1.0, float("nan")])
    out, fell = kernels.call_with_fallback(lambda: nan, lambda: torch.zeros(2),
                                           check=kernels.all_finite)
    assert fell and torch.equal(out, torch.zeros(2))
    with pytest.raises(ZeroDivisionError):
        kernels.call_with_fallback(boom, lambda x: 1 / 0, 0)
    st = kernels.fallback_stats()
    assert dataclasses.asdict(st) == dict(calls=4, fallbacks=3, raised=2, numeric_trips=1,
                                          last_error="ValueError: bad launch")
    assert kernels.all_finite(torch.ones(3), torch.arange(3))
    assert not kernels.all_finite(torch.tensor([float("inf")]))
    kernels.reset_fallback_stats()
    assert kernels.fallback_stats() == kernels.FallbackStats()


# ---------------------------------------------------------------------------
# the reference serving path against JAX's CPU default
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = jax_reference("refserve", tmp_path_factory.mktemp("jax_refserve"))
    assert float(out["params_checksum"]) == params_checksum(model[1])
    return json.loads(str(out["refserve_json"]))


REF_RUNS = dict(SERVE_RUNS, int8=({}, dict(max_batch=4, cache_len=64, page_size=8,
                                           kv_dtype="int8")))


@pytest.mark.parametrize("run", sorted(REF_RUNS))
def test_reference_streams_token_identical_to_jax_reference_engine(model, ref, run):
    cfg, _, params = model
    req_kw, eng_kw = REF_RUNS[run]
    eng = PagedEngine(cfg, params, device="cpu", **eng_kw)
    kernels.reset_launch_counts()
    with kernels.use_policy("reference"):
        done = eng.run([Request(rid=r, prompt=p, max_new=m) for r, p, m in serve_requests(**req_kw)])
    eng.check()
    assert {str(r.rid): r.out for r in done} == ref[run]["out"]
    st = eng.stats()
    for key, val in ref[run]["stats"].items():
        assert st[key] == val, key
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
