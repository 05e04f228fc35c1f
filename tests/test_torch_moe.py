"""The port's mixture-of-experts slice against the JAX package: ``nn/moe.py``,
``kernels.grouped_linear``, the multi-stage MoE model layout of
``models/lm.py`` and ``weights.py``, and the dense ``Server`` on
``moonshot-v1-16b-a3b`` (reduced).

* The five properties of ``tests/test_moe.py``, on the port's ``moe``.
* ``moe`` against JAX's ``moe`` on the same converted parameters and
  inputs: top-1/2/6, 0/1/2 shared experts, ``glu`` on and off, a router
  softcap, a group size that regroups and a sequence it does not divide,
  a sequence long enough that capacity drops slots, and a zero router
  (every probability ties: ``jax.lax.top_k`` takes the lower expert
  index first, the port a stable descending sort).  JAX runs every
  kernel under ``backend=pallas`` (interpret mode).
* ``grouped_linear`` against JAX's under ``tiled``, ``mcast``,
  ``unicast`` and ``reference``, with lead axes and an activation (the
  schedule each side resolves for the grouped problem is held in
  ``tests/test_torch_dispatch.py``).
* ``forward`` (logits and aux loss), ``prefill`` and ``decode_step``
  logits of the reduced moonshot and llama4 configs, weights carried over
  by ``from_jax_params`` (JAX in a child process with excess precision
  off, ``_torch_jax_ref.py`` mode ``moe``).
* The launcher's dense ``Server`` streams, token-identical to the JAX
  launcher's under the default, ``mcast`` and ``unicast`` policies on
  prompts of five different lengths (mode ``moeserve``), and paged serving
  of an MoE arch refused with JAX's ``ValueError``.

Tolerances (``TOL`` in ``_torch_util.py``): bf16 outputs 2e-2 (two bf16
ulps: the kernels' fp32 sums are reordered against the plain versions');
fp32 aux losses of one layer 1e-5 (the router logits are fp32 products
summed in other orders).  Whole-model logits and aux losses sit on bf16
activations, where a reordered sum now and then rounds to the other
neighbour of a tie.  On these random weights the layers grow the
residual stream to |x| of several hundred (the expert weights' fan-in is
their expert axis, as in the JAX package), where one bf16 ulp is 2 to 4,
and such a rounding carries to the logits: in the reduced llama4 24 of
24,576 forward logits leave the elementwise bf16 tolerance, by up to
0.047 at max |logit| 4.3, while every layer's attention and feed-forward
outputs stay within it on the same inputs
(``test_layers_match_jax_on_the_same_inputs``).  So the logits are held
as ``chip_smoke.py`` holds whole-model logits, to rtol 2e-2 plus 2e-2 x
the largest |logit| (``MODEL``), with at most 0.25 % of them outside the
elementwise bf16 tolerance, and the aux losses at the bf16 tolerance.
"""
import contextlib
import dataclasses
import io
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import (
    DENSE_POLICIES,
    MOE_ARCHS,
    MOE_LAUNCH_ARGS,
    SEED,
    moe_case,
    params_checksum,
)
from _torch_util import TOL, close, jax_reference, t
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.configs.base import MoeConfig as JaxMoeConfig
from repro.kernels import api as jax_api
from repro.models import lm as jax_lm
from repro.nn import moe as jax_moe
from repro.nn.spec import init_params as jax_init_params
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.configs.base import MoeConfig

from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.nn.spec import tree_params
from repro_torch.serve import PagedEngine
from repro_torch.weights import from_jax_params

KEY = jax.random.PRNGKey(5)
AUX = dict(rtol=1e-5, atol=1e-6)  # one layer's fp32 aux loss (see the module docstring)
MODEL = 2e-2  # whole-model logits: rtol, and atol as a share of max |logit| (chip_smoke)


def close_logits(got: torch.Tensor, want) -> None:
    """Within ``MODEL``, and at most 0.25 % of the logits outside the
    elementwise bf16 tolerance (the reduced llama4's forward: 24 of
    24,576)."""
    want, got = np.asarray(want, np.float32), got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=MODEL, atol=MODEL * float(np.abs(want).max()))
    outside = ~np.isclose(got, want, **TOL[torch.bfloat16])
    assert outside.mean() <= 2.5e-3, f"{outside.sum()} of {outside.size} logits"


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(d, glu=True, **kw):
    """(JAX params, port params, port config) of one MoE layer, from KEY."""
    jcfg = JaxMoeConfig(**kw)
    jparams = jax_init_params(jax_moe.moe_spec(d, jcfg, glu=glu), KEY)
    return jparams, {k: t(v) for k, v in jparams.items()}, MoeConfig(**kw), jcfg


# ---- the properties of tests/test_moe.py, on the port ------------------------


def test_top1_equals_selected_expert_dense_compute():
    """Top-1 MoE output == running the selected expert densely."""
    d, e = 16, 4
    _, params, cfg, _ = _pair(d, n_experts=e, top_k=1, d_ff_expert=32, capacity_factor=4.0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, d))
                         .astype(np.float32)) * 0.5
    y, aux = moe.moe(params, x, cfg, act="silu", glu=True)
    xf = x.reshape(-1, d)
    eid = (xf @ params["router"]).argmax(-1)
    ref = []
    for i in range(xf.shape[0]):
        w_in, w_gate, w_out = (params[n][eid[i]].float() for n in ("w_in", "w_gate", "w_out"))
        h = torch.nn.functional.silu(xf[i] @ w_gate) * (xf[i] @ w_in)
        ref.append(h @ w_out)  # top-1 gate normalises to 1.0
    np.testing.assert_allclose(y.numpy(), torch.stack(ref).reshape(2, 8, d).numpy(),
                               rtol=2e-3, atol=2e-3)
    assert torch.isfinite(aux)


def test_topk_weights_sum_to_one():
    """Finite, and permuting the tokens permutes the outputs."""
    d = 8
    _, params, cfg, _ = _pair(d, n_experts=8, top_k=3, d_ff_expert=16, capacity_factor=8.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 16, d)).astype(np.float32))
    y, _ = moe.moe(params, x, cfg)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(16))
    y_perm, _ = moe.moe(params, x[:, perm], cfg)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y[:, perm].numpy(), y_perm.numpy(), rtol=2e-3, atol=2e-3)


def test_capacity_drops_overflow_tokens():
    """Tiny capacity on a group of 128 slots (groups of <= 64 slots are
    drop-free) -> cap 1, at most 2 tokens routed, the rest contribute 0."""
    d = 8
    _, params, cfg, _ = _pair(d, n_experts=2, top_k=1, d_ff_expert=16, capacity_factor=1e-9,
                              group_size=128)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 128, d)).astype(np.float32))
    y, _ = moe.moe(params, x, cfg)
    assert moe.capacity(1, 128, 2, 1e-9) == 1
    assert int((y.abs() <= 1e-6).all(dim=-1).sum()) >= 120


def test_shared_expert_always_active():
    """Dropped tokens still get the shared expert's contribution."""
    d = 8
    _, params, cfg, _ = _pair(d, n_experts=2, top_k=1, d_ff_expert=16, n_shared_experts=1,
                              capacity_factor=1e-9)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 8, d)).astype(np.float32))
    y, _ = moe.moe(params, x, cfg)
    assert not (y.abs() <= 1e-6).all(dim=-1).any()


def test_aux_loss_uniform_router_is_one():
    """Balanced routing gives aux ~= 1 (Switch normalisation)."""
    d = 8
    _, params, cfg, _ = _pair(d, n_experts=4, top_k=1, d_ff_expert=16)
    params["router"] = torch.zeros_like(params["router"])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 64, d)).astype(np.float32))
    _, aux = moe.moe(params, x, cfg)
    assert float(aux) == pytest.approx(1.0, abs=0.05)


# ---- moe against JAX's moe ---------------------------------------------------

#: (name, moe config, glu, (batch, seq), zero router)
MOE_CASES = [
    ("top1", dict(n_experts=8, top_k=1, d_ff_expert=32), True, (2, 12), False),
    ("top2-shared1", dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1), True,
     (2, 12), False),
    ("top6-shared2", dict(n_experts=16, top_k=6, d_ff_expert=24, n_shared_experts=2), True,
     (2, 10), False),
    ("glu-off", dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1), False,
     (2, 12), False),
    ("softcap", dict(n_experts=8, top_k=2, d_ff_expert=32, router_softcap=0.5), True,
     (2, 12), False),
    ("regroup", dict(n_experts=8, top_k=2, d_ff_expert=32, group_size=8), True, (2, 32), False),
    ("no-regroup", dict(n_experts=8, top_k=2, d_ff_expert=32, group_size=8), True, (2, 20),
     False),
    ("drops", dict(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.0), True, (2, 96),
     False),
    ("zero-router", dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1), True,
     (2, 48), True),
]


@pytest.mark.parametrize("name,kw,glu,shape,zero", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_matches_jax(name, kw, glu, shape, zero):
    d = 32
    jparams, params, cfg, jcfg = _pair(d, glu=glu, **kw)
    if zero:
        jparams = dict(jparams, router=jnp.zeros_like(jparams["router"]))
        params["router"] = torch.zeros_like(params["router"])
    x = jnp.asarray(np.random.default_rng(len(name)).standard_normal((*shape, d)), jnp.bfloat16)
    with jax_kernels.use_policy("backend=pallas"):
        want, want_aux = jax_moe.moe(jparams, x, jcfg, act="silu", glu=glu)
    got, aux = moe.moe(params, t(x), cfg, act="silu", glu=glu)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX)
    s, k = shape[1], kw["top_k"]
    if name == "regroup":  # 32 tokens route in windows of 8: 16 slots each, drop-free
        assert moe.capacity(k, 8, 8, 1.25) == 16
    if name in ("drops", "zero-router"):  # capacity short of the slots: some drop
        cap = moe.capacity(k, s, kw["n_experts"], kw.get("capacity_factor", 1.25))
        assert cap < k * s
        roomy = dataclasses.replace(cfg, capacity_factor=100.0)
        assert not torch.equal(moe.moe(params, t(x), roomy, glu=glu)[0], got)


def test_zero_router_routes_ties_to_the_lowest_experts():
    """Every probability ties: both packages pick experts 0 .. k-1."""
    probs = torch.full((2, 5, 8), 1 / 8)
    vals, ids = moe.top_k(probs, 3)
    jvals, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert ids.tolist() == np.asarray(jids).tolist() == [[[0, 1, 2]] * 5] * 2
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("k", [2, 3, 6])
def test_k_slot_sum_rounds_once_as_xla_does(k):
    """The combine's bf16 sum over the k slots (JAX ``y.reshape(b, k, s,
    d).sum(axis=1)``): XLA's CPU reduce accumulates in fp32 and rounds
    once, and so does the port's ``sum(dim=1)`` — bit-equal on 20,000
    sums of values spread over many binades."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((1, k, 1, 20000)) * np.exp(rng.standard_normal((1, k, 1, 20000)) * 3)
    x = jnp.asarray(a, jnp.bfloat16)
    want = jax.jit(lambda v: v.sum(axis=1))(x)
    got = t(x).sum(dim=1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    once = t(x).float().sum(dim=1).to(torch.bfloat16)
    assert torch.equal(got, once)


@pytest.mark.parametrize("k,s,e,cf", [(6, 1, 64, 1.25), (6, 10, 64, 1.25), (6, 11, 64, 1.25),
                                      (6, 512, 64, 1.25), (2, 96, 4, 1.0), (1, 128, 2, 1e-9),
                                      (2, 33, 8, 0.3)])
def test_capacity_is_jax_formula(k, s, e, cf):
    """``capacity`` is the JAX expression, float floor division and all:
    decode (s = 1) takes k slots, a 512-token moonshot prompt 60."""
    want = int(max(1, min(-(-k * s * cf // e), k * s)))
    if k * s <= 64:
        want = k * s
    assert moe.capacity(k, s, e, cf) == want
    if (k, s, e) == (6, 512, 64):
        assert want == 60


# ---- grouped_linear ----------------------------------------------------------


@pytest.mark.parametrize("policy", ["tiled", "mcast", "unicast", "reference"])
@pytest.mark.parametrize("activation", [None, "silu", "gelu"], ids=str)
@pytest.mark.parametrize("lead", [(), (2,), (2, 3)], ids=str)
def test_grouped_linear_matches_jax(policy, activation, lead):
    rng = np.random.default_rng(len(lead))
    g, m, k, n = 4, 5, 32, 24
    x = jnp.asarray(rng.standard_normal((*lead, g, m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((g, k, n)) / np.sqrt(k), jnp.bfloat16)
    want = jax_api.grouped_linear(x, w, activation=activation, policy=policy)
    got = kernels.grouped_linear(t(x), t(w), activation=activation, policy=policy)
    assert got.shape == (*lead, g, m, n) and got.dtype == torch.bfloat16
    close(got, want)


def test_grouped_linear_cpu_path_launches_nothing_and_refuses_grad():
    """On the CPU each schedule runs its plain version (no launch
    counted), differentiated too: a kernel schedule's backward (since the
    training slice: grouped z, dA and dB) gives the reference oracle's
    gradient, which autograd takes natively, within the bf16 tolerance,
    and launches nothing either.  The name is the one the test had when
    that call refused the gradient."""
    kernels.reset_launch_counts()
    x, w = torch.randn(2, 4, 3, 16).bfloat16(), torch.randn(4, 16, 8).bfloat16()
    for policy in ("tiled", "mcast", "unicast"):
        kernels.grouped_linear(x, w, policy=policy)
    grads = {}
    for policy in ("tiled", "reference"):
        wg = w.clone().requires_grad_()
        y = kernels.grouped_linear(x, wg, policy=policy)
        grads[policy], = torch.autograd.grad(y.float().sum(), [wg])
    assert set(kernels.launch_counts().values()) == {0}
    assert grads["tiled"].shape == w.shape and grads["tiled"].dtype == torch.bfloat16
    close(grads["tiled"], grads["reference"].float())


def test_grouped_kernels_plain_versions_are_per_group_products():
    """The grouped plain versions are the 2-D plain versions group by group,
    K1's bias shared or one per group."""
    from repro_torch.kernels.matmul import (
        matmul_mcast_plain,
        matmul_tiled_plain,
        matmul_unicast_plain,
    )

    a, b = torch.randn(3, 5, 16).bfloat16(), torch.randn(3, 16, 7).bfloat16()
    for bias in (torch.randn(7), torch.randn(3, 7)):
        got = matmul_tiled_plain(a, b, bias, activation="silu")
        for g in range(3):
            one = matmul_tiled_plain(a[g], b[g], bias if bias.ndim == 1 else bias[g],
                                     activation="silu")
            assert torch.equal(got[g], one)
    for fn in (matmul_mcast_plain, matmul_unicast_plain):
        assert torch.equal(fn(a, b)[1], fn(a[1], b[1]))
    with pytest.raises(ValueError, match="G, M, K"):
        matmul_mcast_plain(a, b[:2])


# ---- the model: layout, logits, aux ------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    arch = request.param
    cfg = get_config(arch, reduced=True)
    jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
    return arch, cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("moe", tmp_path_factory.mktemp("jax_moe"))


def test_configs_are_the_jax_configs():
    for arch in MOE_ARCHS:
        for reduced in (False, True):
            want = dataclasses.asdict(jax_config(arch, reduced=reduced))
            assert dataclasses.asdict(get_config(arch, reduced=reduced)) == want


def test_full_width_parameter_counts_match_jax():
    """moonshot-v1-16b-a3b holds about 28.05 B parameters (26.02 B of them
    routed experts), about 56.1 GB in bf16: one H100."""
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        assert cfg.params_count() == jax_config(arch).params_count()
        assert cfg.active_params_count() == jax_config(arch).active_params_count()
    cfg = get_config("moonshot-v1-16b-a3b")
    assert round(cfg.params_count() / 1e9, 2) == 28.05
    assert 47 * 64 * 3 * 2048 * 1408 == 26_021_462_016


def test_converter_carries_every_stage(model):
    """Layer i of the port is JAX's stage / repeat / block in order; MoE
    leaves keep their expert axis and cross bit-exact."""
    arch, cfg, jparams, params = model
    assert len(params["layers"]) == cfg.n_layers
    i = 0
    for si, (pattern, repeats) in enumerate(cfg.stages):
        for r in range(repeats):
            for j, bd in enumerate(pattern):
                layer, block = params["layers"][i], jparams[f"stage{si}"][f"b{j}"]
                assert ("moe" in layer) == (bd.ff == "moe") and ("mlp" in layer) == (bd.ff == "mlp")
                ff = "moe" if bd.ff == "moe" else "mlp"
                for leaf, val in layer[ff].items():
                    want = np.asarray(block[ff][leaf][r], np.float32)
                    np.testing.assert_array_equal(val.float().numpy(), want)
                i += 1
    n = sum(x.numel() for x in jax.tree.leaves(
        [params["embed"], params["final_norm"], params["layers"], params.get("unembed", {})]))
    assert n == tree_params(lm.model_spec(cfg)) == cfg.params_count()


def test_layers_match_jax_on_the_same_inputs(model):
    """Each layer of the reduced model against JAX's on the same inputs
    (Pallas, interpret mode, op by op): its attention output, then its
    feed-forward output (dense MLP or MoE) on JAX's ``x + attention``,
    each within the bf16 tolerance, the MoE aux losses within ``AUX``.
    The sums with the residual are not compared: on these weights a
    feed-forward output of several hundred can cancel against a residual
    of the same size, and a one-ulp rounding of the output becomes a few
    percent of the sum — which is also why the whole model's logits are
    held to ``MODEL``."""
    from repro.nn import attention as jax_attention
    from repro.nn.module import rmsnorm as jax_rmsnorm
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn.module import rmsnorm

    arch, cfg, jparams, params = model
    jcfg = jax_config(arch, reduced=True)
    tokens = jnp.asarray(moe_case()["dense"])
    layers = iter(params["layers"])
    with jax_kernels.use_policy("backend=pallas"):
        x = jax_lm._embed_inputs(jparams, jcfg, tokens)
        for si, (pattern, repeats) in enumerate(jcfg.stages):
            for r in range(repeats):
                for j, bd in enumerate(pattern):
                    p = jax.tree.map(lambda a: a[r], jparams[f"stage{si}"][f"b{j}"])
                    layer = next(layers)
                    jm = jax_attention.attention(p["attn"], jax_rmsnorm(p["norm1"], x), jcfg.attn,
                                                 window=None, causal=True)
                    m, _ = attn_mod.attention(layer["attn"], rmsnorm(layer["norm1"], t(x)),
                                              cfg.attn)
                    close(m, jm)
                    x = x + jm
                    h, th = jax_rmsnorm(p["norm2"], x), rmsnorm(layer["norm2"], t(x))
                    if bd.ff == "moe":
                        jf, want_aux = jax_moe.moe(p["moe"], h, jcfg.moe, act=jcfg.act,
                                                   glu=jcfg.glu)
                        f, aux = moe.moe(layer["moe"], th, cfg.moe, act=cfg.act, glu=cfg.glu)
                        np.testing.assert_allclose(float(aux), float(want_aux), **AUX)
                    else:
                        jf, f = jax_lm.mlp(p["mlp"], h, jcfg), lm.mlp(layer["mlp"], th, cfg)
                    close(f, jf)
                    x = x + jf


def test_reference_params_are_these_params(model, ref):
    arch, _, jparams, _ = model
    assert float(ref[f"{arch}/params_checksum"]) == params_checksum(jparams)


def test_forward_logits_and_aux_match(model, ref):
    arch, cfg, _, params = model
    logits, aux = lm.forward(params, cfg, torch.from_numpy(moe_case()["dense"]).long())
    assert logits.dtype == aux.dtype == torch.float32 and float(aux) > 0
    close_logits(logits, ref[f"{arch}/forward"])
    close(aux, ref[f"{arch}/aux"], torch.bfloat16)


def test_prefill_and_decode_logits_match(model, ref):
    """A 13-token prefill into 32-slot dense caches (logits at rows 12 and
    7), then a 1-token and a 3-token decode step against them."""
    arch, cfg, _, params = model
    case = moe_case()
    logits, caches = lm.prefill(params, cfg, torch.from_numpy(case["prompt"]).long(),
                                cache_slots=32, logit_index=torch.tensor([12, 7]))
    close_logits(logits, ref[f"{arch}/prefill"])
    logits, caches = lm.decode_step(params, cfg, caches, torch.from_numpy(case["step1"]).long(),
                                    13)
    close_logits(logits, ref[f"{arch}/decode1"])
    logits, caches = lm.decode_step(params, cfg, caches, torch.from_numpy(case["step3"]).long(),
                                    14)
    close_logits(logits, ref[f"{arch}/decode3"])


# ---- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def moonshot():
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    jparams = jax_lm.init(jax_config("moonshot-v1-16b-a3b", reduced=True),
                          jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory, moonshot):
    out = jax_reference("moeserve", tmp_path_factory.mktemp("jax_moeserve"))
    assert float(out["params_checksum"]) == params_checksum(moonshot[1])
    return json.loads(str(out["moeserve_json"]))


def _port_stdout(params, args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        launcher.main([*args, "--device", "cpu"], params=params)
    return buf.getvalue()


@pytest.mark.parametrize("policy", DENSE_POLICIES)
def test_dense_server_streams_match_jax_launcher(moonshot, served, policy):
    """Six prompts of five lengths (4-11 tokens, none a multiple of the
    16-token bucket), 8 new tokens each: the port's stdout equals the JAX
    launcher's, line for line."""
    got = _port_stdout(moonshot[2], [*MOE_LAUNCH_ARGS, "--kernel-policy", policy])
    want = served["runs"][policy]
    lines = [ln for ln in want.splitlines() if ln.startswith("req ")]
    assert len(lines) == 6 and len({ln.split("[")[1].split("]")[0] for ln in lines}) == 5
    assert got == want


def test_dense_server_buckets_only_where_padding_is_exact(moonshot):
    """MoE turns bucketing off (JAX's rule), so each prompt prefills at its
    own length; a dense global-attention decoder keeps its buckets."""
    cfg, _, params = moonshot
    assert launcher.Server(cfg, params, device="cpu")._bucket is None
    dense = get_config("qwen1.5-0.5b", reduced=True)
    assert launcher.Server(dense, lm.init(dense, device="cpu"), device="cpu")._bucket == 16
    seen = []
    real = lm.prefill

    def record(params_, cfg_, tokens, **kw):
        seen.append(tokens.shape[1])
        return real(params_, cfg_, tokens, **kw)

    server = launcher.Server(cfg, params, device="cpu")
    reqs = launcher.make_requests(cfg, n=3, max_new=2, shared_prefix=0, seed=SEED)
    with mock.patch.object(lm, "prefill", record):
        server.run(reqs)
    assert seen == [len(r.prompt) for r in reqs]


def test_paged_serving_refuses_moe_as_jax_does(moonshot, served):
    cfg, _, params = moonshot
    want = served["errors"]
    assert set(want) == {"init_paged_cache", "PagedEngine", "launcher"}
    with pytest.raises(ValueError) as e:
        lm.init_paged_cache(cfg, 8, 8, device="cpu")
    assert str(e.value) == want["init_paged_cache"]
    with pytest.raises(ValueError) as e:
        PagedEngine(cfg, params, device="cpu")
    assert str(e.value) == want["PagedEngine"]
    with pytest.raises(ValueError) as e:
        _port_stdout(params, [*MOE_LAUNCH_ARGS[:-1], "paged"])
    assert str(e.value) == want["launcher"]


def test_dense_caches_admit_moe(moonshot):
    """MoE blocks take dense caches; a block without a feed-forward is
    ported too (mamba2's, ``tests/test_torch_recurrent.py``), and a
    post-block norm; an MoE block without its config is refused."""
    cfg = moonshot[0]
    caches = lm.init_cache(cfg, 2, 16, device="cpu")
    assert len(caches) == cfg.n_layers
    lm.check_supported(cfg)
    no_ff = dataclasses.replace(cfg, stages=(((dataclasses.replace(
        cfg.stages[0][0][0], ff="none"),), 1), cfg.stages[1]))
    lm.check_supported(no_ff)
    assert "norm2" not in lm.block_spec(no_ff, no_ff.stages[0][0][0])
    lm.check_supported(dataclasses.replace(cfg, post_block_norm=True))
    with pytest.raises(ValueError, match="ff=moe without cfg.moe"):
        lm.check_supported(dataclasses.replace(cfg, moe=None))
