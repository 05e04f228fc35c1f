"""Gradients through the port's kernel registry against the JAX
package's custom VJPs.

* ``torch.autograd.grad`` through ``repro_torch.kernels.op("flash_attention")``
  (K6 forward, K7 + K8 backward, the GQA group sum) against ``jax.grad``
  through ``repro.kernels.op("flash_attention")(..., policy="pallas")``
  (the Pallas kernels in interpret mode, blocks from JAX's autotuner);
* ``grad(linear)`` under forced ``tiled``, ``mcast`` and ``unicast``
  against JAX's ``linear(policy=...)``, with bias and silu, and with no
  epilogue but a bf16 ``out_dtype``;
* ``torch.autograd.grad`` through ``op("ssd")`` (K9 forward with its
  checkpoints, K10 backward, dB and dC summed over heads) and
  ``op("rglru")`` (K11, K12) against ``jax.grad`` through JAX's
  ``op(..., policy="pallas")``, at 2e-3 and 1e-3 (the JAX package's own
  parity tolerances: its chunk and blocks differ from the port's, which
  reorders the fp32 sums);
* differentiation-aware dispatch: a forced forward schedule does not
  force the backward, paged attention cannot be differentiated, and
  ``resolve(..., needs_vjp=True)`` picks what JAX picks.

A fixed random cotangent (``(out * g).sum()``) probes the full VJP, as
``tests/test_grad.py`` does.  Stated tolerances: fp32 1e-4 (the two
sides sum in other orders), bf16 2e-2 (about two bf16 ulps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro import kernels as jax_kernels
from repro.kernels import autotune as jax_autotune
from repro_torch import kernels
from repro_torch.kernels import api


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _fresh_state(tmp_path, monkeypatch):
    """JAX's dispatch consults its autotune cache: keep it per test."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    jax_autotune.clear_cache()
    jax_kernels.set_policy(None)
    kernels.set_policy(None)
    yield
    jax_autotune.clear_cache()
    jax_kernels.set_policy(None)
    kernels.set_policy(None)


def _arrays(seed, shapes, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(s) * scale, JNP[dtype]) for s in shapes]


def _jax_grads(fn, args, g):
    out = fn(*args)
    grads = jax.grad(lambda *a: (fn(*a).astype(jnp.float32) * g).sum(),
                     argnums=tuple(range(len(args))))(*args)
    return (out, *grads)


def _torch_grads(fn, args, g):
    leaves = [t(a).requires_grad_() for a in args]
    out = fn(*leaves)
    return (out, *torch.autograd.grad((out.float() * t(g)).sum(), leaves))


def _assert_close(got, want, tol):
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x.detach().float().numpy(), np.asarray(y, np.float32),
                                   err_msg=f"output/cotangent #{i}", **tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (b, h, kvh, sq, sk, causal, window, softcap, dtype)
FLASH = [
    (1, 4, 2, 64, 64, True, None, None, torch.float32),    # GQA causal
    (1, 4, 4, 96, 96, True, 24, None, torch.float32),      # sliding window
    (1, 2, 1, 64, 64, True, None, 8.0, torch.float32),     # softcap + MQA
    (2, 4, 2, 64, 96, False, None, None, torch.float32),   # sq != sk, full
    (1, 4, 1, 96, 32, True, 24, None, torch.float32),      # rows that see no key
    (1, 4, 2, 64, 64, True, 24, 8.0, torch.bfloat16),      # everything, bf16
]


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_attention_grad_matches_jax(case):
    b, h, kvh, sq, sk, causal, window, softcap, dtype = case
    d = 16
    args = _arrays(sq + sk + h, [(b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d)], dtype)
    g = _arrays(99, [(b, h, sq, d)], torch.float32)[0]
    opts = dict(causal=causal, window=window, softcap=softcap)
    want = _jax_grads(lambda *a: jax_kernels.op("flash_attention")(*a, policy="pallas", **opts),
                      args, g)
    got = _torch_grads(lambda *a: kernels.op("flash_attention")(*a, **opts), args, g)
    assert [x.dtype for x in got] == [dtype] * 4
    _assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("policy", ["pallas", "schedule=pallas"])
def test_flash_attention_differentiates_under_a_forced_policy(policy):
    args = _arrays(0, [(1, 2, 32, 8)] * 3, torch.float32)
    g = _arrays(1, [(1, 2, 32, 8)], torch.float32)[0]
    fa = kernels.op("flash_attention")
    base = _torch_grads(lambda *a: fa(*a), args, g)
    with kernels.use_policy(policy):
        forced = _torch_grads(lambda *a: fa(*a), args, g)
    for x, y in zip(base, forced):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_flash_runs_where_the_tpu_blocks_do_not_fit():
    """The CUDA tiles mask ragged edges, so dispatch never refuses a
    shape: here no TPU block divides s = 1400 and one 1400-row fp32 block
    at d = 256 overflows the VMEM budget the JAX package dispatches by.
    Forward and gradients hold to autograd through the oracle."""
    from repro_torch.kernels.flash_attention import attention_ref

    b, h, s, d = 1, 1, 1400, 256
    assert not api._fits("flash_attention")(api.Problem((b, h, s, s, d), "float32"))
    rng = np.random.default_rng(7)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32))
                  for _ in range(4))
    grads = []
    for fn in (kernels.op("flash_attention"), attention_ref):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, causal=True)
        grads.append((out, *torch.autograd.grad((out * w).sum(), leaves)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# scans: ssd and rglru
# ---------------------------------------------------------------------------


def _ssd_args(s, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    xdt, bm, cm = (rng.standard_normal(shape) * 0.5 for shape in
                   ((1, 2, s, 32), (1, s, 16), (1, s, 16)))
    log_a = -np.logaddexp(0.0, rng.standard_normal((1, 2, s)))
    return [jnp.asarray(x, JNP[dtype]) for x in (xdt, bm, cm, log_a)]


def _rglru_args(s, d, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = 0.8 + 0.2 / (1.0 + np.exp(-rng.standard_normal((2, s, d))))
    return [jnp.asarray(x, JNP[dtype]) for x in (a, rng.standard_normal((2, s, d)))]


@pytest.mark.parametrize("s", [256, 192, 200])  # 192: JAX's chunk 64; 200: the port's is short
def test_ssd_grad_matches_jax(s):
    args = _ssd_args(s)
    g = _arrays(98, [(1, 2, s, 32)], torch.float32)[0]
    want = _jax_grads(lambda *a: jax_kernels.op("ssd")(*a, policy="pallas"), args, g)
    got = _torch_grads(lambda *a: kernels.op("ssd")(*a), args, g)
    assert [x.dtype for x in got] == [torch.float32] * 5
    _assert_close(got, want, dict(rtol=2e-3, atol=2e-3))


@pytest.mark.parametrize("s,d", [(256, 256), (192, 192)])
def test_rglru_grad_matches_jax(s, d):
    args = _rglru_args(s, d)
    g = _arrays(97, [(2, s, d)], torch.float32)[0]
    want = _jax_grads(lambda *a: jax_kernels.op("rglru")(*a, policy="pallas"), args, g)
    got = _torch_grads(lambda *a: kernels.op("rglru")(*a), args, g)
    _assert_close(got, want, dict(rtol=1e-3, atol=1e-3))


def test_scan_grads_of_bf16_inputs_come_back_in_their_dtypes():
    """bf16 inputs: the scans run in fp32 (outputs fp32), each gradient
    comes back in its input's dtype, and RG-LRU's db in a's dtype.  The
    port cumsums the SSD log-decays in fp32, where the JAX package
    cumsums them in bf16, so the SSD values are held to JAX run on the
    same bf16 values upcast to fp32; RG-LRU's to JAX run on the bf16
    inputs themselves.  Tolerance: bf16's (one rounding of each grad)."""
    args = _ssd_args(128, torch.bfloat16)
    g = _arrays(96, [(1, 2, 128, 32)], torch.float32)[0]
    got = _torch_grads(lambda *a: kernels.op("ssd")(*a), args, g)
    assert [x.dtype for x in got] == [torch.float32] + [torch.bfloat16] * 4
    want = _jax_grads(lambda *a: jax_kernels.op("ssd")(*a, policy="pallas"),
                      [x.astype(jnp.float32) for x in args], g)
    _assert_close(got, want, TOL[torch.bfloat16])

    args = _rglru_args(128, 128, torch.bfloat16)
    g = _arrays(95, [(2, 128, 128)], torch.float32)[0]
    got = _torch_grads(lambda *a: kernels.op("rglru")(*a), args, g)
    assert [x.dtype for x in got] == [torch.float32, torch.bfloat16, torch.bfloat16]
    want = _jax_grads(lambda *a: jax_kernels.op("rglru")(*a, policy="pallas"), args, g)
    _assert_close(got, want, TOL[torch.bfloat16])
    # bf16 a, fp32 b: db is rounded to a's dtype (autograd then casts it
    # back to b's fp32)
    a, b = t(args[0]).requires_grad_(), t(args[1]).float().requires_grad_()
    _, db = torch.autograd.grad(kernels.op("rglru")(a, b).sum(), (a, b))
    assert db.dtype == torch.float32
    torch.testing.assert_close(db, db.bfloat16().float(), rtol=0, atol=0)


def test_ssd_runs_where_the_tpu_state_does_not_fit():
    """(P, N) = (3072, 1024): a 12 MB fp32 state that overflows the VMEM
    budget the JAX package dispatches by (JAX falls back to its reference
    there); the port's kernels stream the state through N tiles, so
    dispatch runs them.  Forward and gradients hold to autograd through
    the sequential oracle."""
    from repro_torch.kernels.ssd import ssd_scan_ref

    b, h, s, p, n = 1, 1, 3, 3072, 1024
    assert not api._fits("ssd")(api.Problem((b, h, s, p, n), "float32"))
    rng = np.random.default_rng(9)
    xdt = torch.from_numpy(rng.standard_normal((b, h, s, p), np.float32) * 0.5)
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n), np.float32) * 0.05)
              for _ in range(2))
    log_a = -torch.rand(b, h, s, generator=torch.Generator().manual_seed(0))
    w = torch.from_numpy(rng.standard_normal((b, h, s, p), np.float32))
    grads = []
    for fn in (kernels.op("ssd"), ssd_scan_ref):
        leaves = [x.clone().requires_grad_() for x in (xdt, bm, cm, log_a)]
        out = fn(*leaves)
        grads.append((out, *torch.autograd.grad((out * w).sum(), leaves)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# matmul: kernels.linear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["tiled", "mcast", "unicast"])
@pytest.mark.parametrize("m,k,n", [(24, 96, 40), (37, 70, 33)])  # tidy + ragged
def test_linear_grad_bias_silu_matches_jax(schedule, m, k, n):
    args = _arrays(m + n, [(m, k), (k, n), (n,)], torch.float32, scale=0.5)
    g = _arrays(99, [(m, n)], torch.float32)[0]
    want = _jax_grads(lambda a, b, c: jax_kernels.linear(a, b, bias=c, activation="silu",
                                                         policy=schedule), args, g)
    got = _torch_grads(lambda a, b, c: kernels.linear(a, b, bias=c, activation="silu",
                                                      policy=schedule), args, g)
    _assert_close(got, want, TOL[torch.float32])


@pytest.mark.parametrize("schedule", ["tiled", "mcast", "unicast"])
def test_linear_grad_no_epilogue_out_dtype_matches_jax(schedule):
    """bf16 output: the cotangent reaches the matmuls bf16-quantised on
    both sides; dA and dB stay fp32 (the inputs' dtype)."""
    args = _arrays(5, [(32, 48), (48, 24)], torch.float32, scale=0.5)
    g = _arrays(98, [(32, 24)], torch.float32)[0]
    want = _jax_grads(lambda a, b: jax_kernels.linear(a, b, out_dtype=jnp.bfloat16,
                                                      policy=schedule), args, g)
    got = _torch_grads(lambda a, b: kernels.linear(a, b, out_dtype=torch.bfloat16,
                                                   policy=schedule), args, g)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    _assert_close(got[:1], want[:1], TOL[torch.bfloat16])
    _assert_close(got[1:], want[1:], TOL[torch.float32])


def test_linear_grad_of_bf16_operands_keeps_their_dtypes():
    args = _arrays(7, [(16, 32), (32, 8), (8,)], torch.bfloat16)
    g = _arrays(97, [(16, 8)], torch.float32)[0]
    want = _jax_grads(lambda a, b, c: jax_kernels.linear(a, b, bias=c, activation="gelu",
                                                         policy="tiled"), args, g)
    got = _torch_grads(lambda a, b, c: kernels.linear(a, b, bias=c, activation="gelu",
                                                      policy="tiled"), args, g)
    assert [x.dtype for x in got] == [torch.bfloat16] * 4
    _assert_close(got, want, TOL[torch.bfloat16])


def _spy(monkeypatch):
    """Record every (family, shape, policy, needs_vjp) -> schedule the
    port's dispatch resolves."""
    seen = []
    orig = api.KernelOp.resolve

    def spy(self, problem, policy=None, *, needs_vjp=False):
        sched = orig(self, problem, policy, needs_vjp=needs_vjp)
        seen.append((self.name, problem.shape, str(policy), needs_vjp, sched.name))
        return sched

    monkeypatch.setattr(api.KernelOp, "resolve", spy)
    return seen


@pytest.mark.parametrize("schedule", ["mcast", "unicast", "tiled"])
def test_forced_forward_schedule_does_not_force_the_backward(monkeypatch, schedule):
    """The forward runs the forced schedule; the backward's z, dA and dB
    resolve under ``backend=pallas`` — the cheapest kernel for their own
    shapes, JAX's pick for each — never the forced one by name."""
    seen = _spy(monkeypatch)
    args = _arrays(3, [(24, 96), (96, 40), (40,)], torch.float32)
    g = _arrays(4, [(24, 40)], torch.float32)[0]
    _torch_grads(lambda a, b, c: kernels.linear(a, b, bias=c, activation="relu",
                                                policy=schedule), args, g)
    fwd, *bwd = seen
    assert fwd[0] == "matmul" and fwd[3] is True and fwd[4] == schedule
    assert [s[1] for s in bwd] == [(24, 96, 40), (24, 40, 96), (96, 24, 40)]  # z, dA, dB
    for _, shape, policy, needs_vjp, picked in bwd:
        assert policy == str(api.as_policy("backend=pallas")) and needs_vjp is False
        want = jax_kernels.resolve("matmul", shape, "float32", "backend=pallas").schedule
        assert picked == want == "tiled"


def test_unforced_backward_follows_the_ambient_policy(monkeypatch):
    """Without a forced forward, the backward resolves under the policy in
    force when it runs (JAX: its own trace time)."""
    seen = _spy(monkeypatch)
    a, b = (t(x).requires_grad_() for x in _arrays(6, [(16, 32), (32, 8)], torch.float32))
    y = kernels.linear(a, b)
    with kernels.use_policy("unicast"):
        torch.autograd.grad(y.sum(), (a, b))
    assert [s[4] for s in seen] == ["tiled", "unicast", "unicast"]  # forward, dA, dB


def test_no_epilogue_backward_makes_no_recompute(monkeypatch):
    seen = _spy(monkeypatch)
    args = _arrays(8, [(16, 32), (32, 8)], torch.float32)
    g = _arrays(9, [(16, 8)], torch.float32)[0]
    _torch_grads(lambda a, b: kernels.linear(a, b, policy="tiled"), args, g)
    assert len(seen) == 3  # forward, dA, dB: no z without an activation


# ---------------------------------------------------------------------------
# dispatch under differentiation
# ---------------------------------------------------------------------------

PAGED = (2, 1, 4, 2, 4, 8, 16, 0)  # decode: (b, s, h, kvh, pages, ps, d, n_scales)


def _paged_call(requires_grad):
    q = torch.randn(2, 1, 4, 16, requires_grad=requires_grad)
    pages = torch.randn(2, 9, 8, 16)
    table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    lengths = torch.tensor([20, 7], dtype=torch.int32)
    return q, pages, pages, table, lengths - 1, lengths


def test_forced_vjpless_schedule_raises_jaxs_error_under_grad():
    msg = "kernel op 'paged_attention': schedule 'pallas' has no VJP but the call is being " \
          "differentiated"
    with pytest.raises(ValueError, match=msg):
        jax_kernels.resolve("paged_attention", PAGED, "bfloat16", "schedule=pallas",
                            needs_vjp=True)
    with pytest.raises(ValueError, match=msg):
        kernels.resolve("paged_attention", PAGED, torch.bfloat16, "schedule=pallas",
                        needs_vjp=True)
    with kernels.use_policy("schedule=pallas"), pytest.raises(ValueError, match=msg):
        kernels.op("paged_attention")(*_paged_call(True))


def test_forced_backend_without_a_vjp_schedule_raises_under_grad():
    msg = "no 'pallas' schedule has a VJP but the call is being differentiated"
    with pytest.raises(ValueError, match=msg):
        jax_kernels.resolve("paged_attention", PAGED, "bfloat16", "backend=pallas",
                            needs_vjp=True)
    with kernels.use_policy("backend=pallas"), pytest.raises(ValueError, match=msg):
        kernels.op("paged_attention")(*_paged_call(True))


def test_auto_dispatched_paged_attention_under_grad_needs_the_reference_backend():
    """Paged attention has no kernel with a VJP: under differentiation JAX's
    auto-dispatch falls back to its (differentiable) reference backend, and
    so does the port's — the gradient of the same loss through the same
    pages equals ``jax.grad``'s."""
    assert jax_kernels.resolve("paged_attention", PAGED, "bfloat16", "reference",
                               needs_vjp=True).backend == "reference"
    got = kernels.resolve("paged_attention", PAGED, torch.bfloat16, needs_vjp=True)
    assert (got.schedule, got.backend, got.vjp) == ("reference", "reference", True)
    q, pages, _, table, start, lengths = _paged_call(True)
    w = torch.randn(q.shape)
    kernels.reset_launch_counts()
    out = kernels.op("paged_attention")(q, pages, pages, table, start, lengths)
    dq, = torch.autograd.grad((out * w).sum(), q)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    j = {name: jnp.asarray(a.detach().numpy()) for name, a in
         dict(q=q, pages=pages, table=table, start=start, lengths=lengths, w=w).items()}
    with jax_kernels.use_policy("reference"):
        want = jax.grad(lambda qq: (jax_kernels.op("paged_attention")(
            qq, j["pages"], j["pages"], j["table"], j["start"], j["lengths"]) * j["w"]).sum())(
            j["q"])
    np.testing.assert_allclose(dq.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_differentiation_needs_grad_mode_and_a_grad_input():
    out = kernels.op("paged_attention")(*_paged_call(False))  # no input requires grad
    assert out.shape == (2, 1, 4, 16)
    with torch.no_grad():
        kernels.op("paged_attention")(*_paged_call(True))
    assert api._needs_vjp(torch.zeros(1, requires_grad=True), None)
    with torch.no_grad():
        assert not api._needs_vjp(torch.zeros(1, requires_grad=True))


@pytest.mark.parametrize("shape", [(1, 4, 64, 64, 16), (2, 16, 2048, 2048, 64),
                                   (1, 16, 8192, 8192, 256), (3, 8, 77, 200, 128),
                                   # no TPU block divides the sequence and the
                                   # whole of it overflows VMEM: JAX's auto
                                   # dispatch goes to its reference, backend=pallas
                                   # and the port to the kernel
                                   (1, 16, 3000, 3000, 256), (1, 4, 5000, 5000, 128)])
@pytest.mark.parametrize("policy", [None, "backend=pallas", "pallas"], ids=str)
@pytest.mark.parametrize("needs_vjp", [False, True])
def test_flash_resolve_matches_jax(shape, policy, needs_vjp):
    want = jax_kernels.resolve("flash_attention", shape, "bfloat16", policy or "backend=pallas",
                               needs_vjp=needs_vjp)
    got = kernels.resolve("flash_attention", shape, torch.bfloat16, policy,
                          needs_vjp=needs_vjp)
    assert (got.schedule, got.backend, got.vjp) == (want.schedule, want.backend, want.vjp)


@pytest.mark.parametrize("shape", [(4, 1024, 1024), (2049, 1024, 2816), (1024, 4096, 2816)])
@pytest.mark.parametrize("policy", [None, "mcast", "backend=pallas"], ids=str)
def test_matmul_resolve_under_grad_matches_jax(shape, policy):
    want = jax_kernels.resolve("matmul", shape, "bfloat16", policy or "backend=pallas",
                               needs_vjp=True)
    got = kernels.resolve("matmul", shape, torch.bfloat16, policy, needs_vjp=True)
    assert (got.schedule, got.vjp) == (want.schedule, want.vjp) and got.vjp


def test_flash_candidates_match_jax():
    from repro_torch.kernels import autotune

    for shape in ((2, 16, 2048, 2048, 64), (1, 16, 8192, 8192, 256), (3, 8, 77, 200, 128),
                  (1, 4, 96, 32, 16)):
        for dt in ("bfloat16", "float32"):
            want = jax_autotune.candidates("flash_attention", shape, dt)
            got = autotune.candidates("flash_attention", shape, dt)
            assert [(c.config, c.vmem_bytes, c.grid_steps, c.cost) for c in got] == \
                [(c.config, c.vmem_bytes, c.grid_steps, c.cost) for c in want]
