"""The port's recurrent slice against the JAX package: ``nn/ssd.py`` (the
Mamba-2 SSD block), ``nn/rglru.py`` (the Griffin RG-LRU block and its
associative scan), the SSM / hybrid model layout of ``models/lm.py`` and
``weights.py``, and the dense ``Server`` on ``mamba2-780m`` and
``recurrentgemma-2b`` (reduced).

* ``ssd`` unpadded, padded (a sequence the chunk does not divide) and
  continued from a carried state, and ``ssd_step``, against JAX's on the
  same parameters and inputs; likewise ``rglru`` with and without a
  carried state and ``rglru_step``.  JAX runs every kernel under
  ``backend=pallas`` (interpret mode).
* The associative scan against ``jax.lax.associative_scan``, and
  ``softplus`` against ``jax.nn.softplus``: bit-equal.
* ``forward`` logits, and ``prefill`` followed by 8 ``decode_step``s, of
  both reduced configs, weights carried over by ``from_jax_params`` (JAX
  in a child process with excess precision off, ``_torch_jax_ref.py``
  mode ``recurrent``).
* The launcher's ``--kv dense`` streams of both reduced configs,
  token-identical to the JAX launcher's under the default, ``mcast`` and
  ``unicast`` policies, and its refusals of paged serving (JAX's errors).
* A window-16 recurrentgemma (the same weights): a 300-token forward on
  the banded path, prefills longer than the 16-slot rings followed by
  decode steps across their wrap, and JAX's ``Server`` streams.

Tolerances (``TOL`` in ``_torch_util.py``): bf16 outputs 2e-2 (two bf16
ulps: the two sides sum fp32 products in other orders, so a rounding may
land on the other side of a tie); the fp32 recurrent states ``STATE``
(rtol 1e-4, atol 1e-5: fp32 sums of up to a chunk of bf16-rounded terms
in other orders, and a state is fed by every step before it).  mamba2's
whole-model logits at the bf16 tolerance, as ``tests/test_torch_model.py``
holds the dense model's.  recurrentgemma's at ``MODEL_RG`` (rtol 2e-2,
atol 6e-2 x max |logit|, at most 0.25 % of them outside the bf16
tolerance): its random-weight residual stream grows to |x| ~ 5,000, where
one bf16 ulp is 32, and the RG-LRU's sqrt(1 - a^2) near a = 1 turns a
last-bit difference in a sigmoid gate (the two sides' fp32 products sum in
other orders) into a rounding of that size, so a logit can move by a few
percent of the largest.  JAX's own forward, eager against jitted, moves as
far (``test_jax_eager_and_jitted_differ_as_far``).  Greedy streams must be
identical, but where the port's top-two margin at the first differing
token is within ``NEAR_TIE`` x that row's largest |logit| (chip_smoke's
rule for a near-tie).
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
    PAGED_ASKS,
    RECURRENT_ARCHS,
    SEED,
    params_checksum,
    recurrent_case,
    recurrent_launch_args,
    window16_config,
    window16_requests,
)
from _torch_util import close, jax_reference, t
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.configs.base import RglruConfig as JaxRglruConfig
from repro.configs.base import SsmConfig as JaxSsmConfig
from repro.models import lm as jax_lm
from repro.nn import rglru as jax_rglru
from repro.nn import ssd as jax_ssd
from repro.nn.spec import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.configs.base import RglruConfig, SsmConfig
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.nn import memeff, rglru, ssd
from repro_torch.nn.spec import tree_params
from repro_torch.serve import GreedySampler, Request
from repro_torch.weights import from_jax_params

KEY = jax.random.PRNGKey(7)
STATE = dict(rtol=1e-4, atol=1e-5)  # fp32 recurrent states (see the module docstring)
MODEL_RG = 6e-2  # recurrentgemma's logits: atol as a share of max |logit| (see above)
NEAR_TIE = 2e-2  # a stream may leave JAX's where the top-two margin is this x max |logit|


def close_model(arch, got: torch.Tensor, want) -> None:
    """mamba2 at the bf16 tolerance; recurrentgemma within ``MODEL_RG`` and
    at most 0.25 % of the logits outside the bf16 tolerance."""
    if arch.startswith("mamba2"):
        close(got, want, torch.bfloat16)
        return
    want, got = np.asarray(want, np.float32), got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=MODEL_RG * float(np.abs(want).max()))
    outside = ~np.isclose(got, want, rtol=2e-2, atol=2e-2)
    assert outside.mean() <= 2.5e-3, f"{outside.sum()} of {outside.size} logits"


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(tree):
    """A JAX parameter tree -> the same nesting of CPU tensors."""
    return {k: _tree(v) if isinstance(v, dict) else t(v) for k, v in tree.items()}


def _inputs(seed, shape):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.bfloat16)


# ---- the SSD block -----------------------------------------------------------

SSM = dict(d_state=16, head_dim=8, expand=2, conv_width=4, chunk=8)
D_SSM = 32


@pytest.fixture(scope="module")
def ssd_pair():
    jcfg, cfg = JaxSsmConfig(**SSM), SsmConfig(**SSM)
    jparams = jax_init_params(jax_ssd.ssd_spec(D_SSM, jcfg), KEY)
    # a non-zero conv bias and dt bias, so both reach the outputs
    rng = np.random.default_rng(1)
    jparams["conv_b"] = jnp.asarray(rng.standard_normal(jparams["conv_b"].shape) * 0.1,
                                    jnp.bfloat16)
    jparams["dt_bias"] = jnp.asarray(rng.standard_normal(jparams["dt_bias"].shape) * 0.5,
                                     jnp.float32)
    return jparams, _tree(jparams), jcfg, cfg


#: (name, batch, sequence, carried): 16 = two whole chunks, 13 pads 3 steps
SSD_CASES = [("unpadded", 2, 16, False), ("padded", 2, 13, False), ("carried", 2, 11, True)]


@pytest.mark.parametrize("name,b,s,carried", SSD_CASES, ids=[c[0] for c in SSD_CASES])
def test_ssd_matches_jax(ssd_pair, name, b, s, carried):
    """Outputs, the carried state and the conv tail (the last 3 *real*
    inputs); ``carried`` continues from the state of an earlier 9-token
    call (a padded one), as a second prompt chunk would."""
    jparams, params, jcfg, cfg = ssd_pair
    u = _inputs(len(name), (b, s, D_SSM))
    jstate, state = None, None
    with jax_kernels.use_policy("backend=pallas"):
        if carried:
            first = _inputs(99, (b, 9, D_SSM))
            _, jstate = jax_ssd.ssd(jparams, first, jcfg)
            _, state = ssd.ssd(params, t(first), cfg)
            np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **STATE)
        want, wst = jax_ssd.ssd(jparams, u, jcfg, state=jstate)
    got, st = ssd.ssd(params, t(u), cfg, state=state)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, D_SSM)
    close(got, want)
    assert st.h.dtype == torch.float32 and st.h.shape == tuple(wst.h.shape)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(wst.h), **STATE)
    close(st.conv, wst.conv)


def test_ssd_step_matches_jax_and_continues_the_sequence(ssd_pair):
    """Three decode steps from a 10-token prefill's state against JAX's
    ``ssd_step``; and the steps agree with the full-sequence block over
    all 13 tokens (the decode path is the same recurrence)."""
    jparams, params, jcfg, cfg = ssd_pair
    u = _inputs(5, (2, 13, D_SSM))
    with jax_kernels.use_policy("backend=pallas"):
        _, jstate = jax_ssd.ssd(jparams, u[:, :10], jcfg)
        _, state = ssd.ssd(params, t(u[:, :10]), cfg)
        full, _ = ssd.ssd(params, t(u), cfg)
        for i in range(10, 13):
            want, jstate = jax_ssd.ssd_step(jparams, u[:, i:i + 1], jstate, jcfg)
            got, state = ssd.ssd_step(params, t(u[:, i:i + 1]), state, cfg)
            close(got, want)
            np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **STATE)
            close(state.conv, jstate.conv)
            close(got, full[:, i:i + 1].float(), torch.bfloat16)


def test_softplus_is_jax_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)): the port's is the same expression, within one fp32
    ulp (XLA's ``exp`` and ``log1p`` are its own approximations: 7.5 % of
    these values round the last bit the other way), exact at the edges and
    NaN where JAX gives NaN."""
    x = np.concatenate([np.random.default_rng(0).standard_normal(4000) * 8,
                        [0.0, -0.0, 30.0, -30.0, 88.0, -104.0, 1e-8, np.inf, -np.inf, np.nan]])
    x = x.astype(np.float32)
    got = ssd.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    np.testing.assert_array_equal(got[-10:], want[-10:])


# ---- the RG-LRU block --------------------------------------------------------

LRU = dict(d_rnn=48, conv_width=4)
D_LRU = 32


@pytest.fixture(scope="module")
def lru_pair():
    jcfg, cfg = JaxRglruConfig(**LRU), RglruConfig(**LRU)
    jparams = jax_init_params(jax_rglru.rglru_spec(D_LRU, jcfg), KEY)
    rng = np.random.default_rng(2)
    for leaf in ("conv_b", "b_a", "b_i"):  # non-zero biases reach the outputs
        jparams[leaf] = jnp.asarray(rng.standard_normal(jparams[leaf].shape) * 0.3,
                                    jnp.bfloat16)
    return jparams, _tree(jparams), jcfg, cfg


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("s", [1, 12, 37])
def test_rglru_matches_jax(lru_pair, carried, s):
    """Outputs, state and conv tail; ``carried`` seeds the scan with the
    state and conv tail of an earlier 7-token call."""
    jparams, params, jcfg, cfg = lru_pair
    x = _inputs(s, (2, s, D_LRU))
    jstate, state = None, None
    with jax_kernels.use_policy("backend=pallas"):
        if carried:
            first = _inputs(98, (2, 7, D_LRU))
            _, jstate = jax_rglru.rglru(jparams, first, jcfg)
            _, state = rglru.rglru(params, t(first), cfg)
        want, wst = jax_rglru.rglru(jparams, x, jcfg, state=jstate)
    got, st = rglru.rglru(params, t(x), cfg, state=state)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, D_LRU)
    close(got, want)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(wst.h), **STATE)
    close(st.conv, wst.conv)


def test_rglru_step_matches_jax_and_continues_the_sequence(lru_pair):
    jparams, params, jcfg, cfg = lru_pair
    x = _inputs(6, (2, 12, D_LRU))
    with jax_kernels.use_policy("backend=pallas"):
        _, jstate = jax_rglru.rglru(jparams, x[:, :9], jcfg)
        _, state = rglru.rglru(params, t(x[:, :9]), cfg)
        full, _ = rglru.rglru(params, t(x), cfg)
        for i in range(9, 12):
            want, jstate = jax_rglru.rglru_step(jparams, x[:, i:i + 1], jstate, jcfg)
            got, state = rglru.rglru_step(params, t(x[:, i:i + 1]), state, cfg)
            close(got, want)
            np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **STATE)
            close(state.conv, jstate.conv)
            close(got, full[:, i:i + 1].float(), torch.bfloat16)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 37, 64, 100, 255])
def test_associative_scan_is_jax_bit_for_bit(n):
    """The RG-LRU recurrence's scan against ``jax.lax.associative_scan``
    on the same (a, b) in fp32: the same combine tree, so every output is
    the same sequence of roundings — bit-equal at every length, odd,
    even and 1."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (3, n, 5)).astype(np.float32)
    b = rng.standard_normal((3, n, 5)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    want = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(a, b)
    got = rglru.associative_scan(rglru._combine, (torch.from_numpy(a), torch.from_numpy(b)),
                                 dim=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    seq = np.zeros((3, 5), np.float32)
    for i in range(n):  # and it is the recurrence h_t = a_t h_{t-1} + b_t
        seq = a[:, i] * seq + b[:, i]
    np.testing.assert_allclose(got[1][:, -1].numpy(), seq, rtol=1e-5, atol=1e-5)


# ---- the models --------------------------------------------------------------


@pytest.fixture(scope="module", params=RECURRENT_ARCHS)
def model(request):
    arch = request.param
    cfg = get_config(arch, reduced=True)
    jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
    return arch, cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("recurrent", tmp_path_factory.mktemp("jax_recurrent"))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_configs_are_the_jax_configs(arch, reduced):
    want = dataclasses.asdict(jax_config(arch, reduced=reduced))
    assert dataclasses.asdict(get_config(arch, reduced=reduced)) == want


def test_full_width_parameter_counts_match_jax():
    """mamba2-780m holds about 0.78 B parameters (1.56 GB in bf16),
    recurrentgemma-2b about 2.89 B (5.8 GB): both fit one H100 at full
    width and full depth."""
    for arch in RECURRENT_ARCHS:
        assert get_config(arch).params_count() == jax_config(arch).params_count()
    assert round(get_config("mamba2-780m").params_count() / 1e9, 2) == 0.78
    assert round(get_config("recurrentgemma-2b").params_count() / 1e9, 2) == 2.89


def test_converter_carries_every_stage(model):
    """Layer i of the port is JAX's stage / repeat / block in order, every
    leaf bit-exact (the fp32 a_log / dt_bias / d_skip / lam, the conv
    weights and biases, the gated norm's nested scale), and the port's
    spec describes exactly the converted tree."""
    arch, cfg, jparams, params = model

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    i = 0
    for si, (pattern, repeats) in enumerate(cfg.stages):
        for r in range(repeats):
            for j, bd in enumerate(pattern):
                layer, block = params["layers"][i], jparams[f"stage{si}"][f"b{j}"]
                assert (bd.mixer in layer) and (("norm2" in layer) == (bd.ff != "none"))
                for path, val in leaves(layer[bd.mixer] if bd.mixer != "attn" else {}):
                    want = block[bd.mixer]
                    for k in path:
                        want = want[k]
                    want = np.asarray(want[r])
                    assert str(val.dtype).endswith(want.dtype.name), path
                    np.testing.assert_array_equal(val.float().numpy(), want.astype(np.float32))
                i += 1
    n = sum(x.numel() for x in jax.tree.leaves(
        [params["embed"], params["final_norm"], params["layers"]]))
    assert n == tree_params(lm.model_spec(cfg)) == cfg.params_count()


def test_reference_params_are_these_params(model, ref):
    arch, _, jparams, _ = model
    assert float(ref[f"{arch}/params_checksum"]) == params_checksum(jparams)


def test_forward_logits_match(model, ref):
    arch, cfg, _, params = model
    logits, aux = lm.forward(params, cfg, torch.from_numpy(recurrent_case()["dense"]).long())
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    close_model(arch, logits, ref[f"{arch}/forward"])


def test_jax_eager_and_jitted_differ_as_far(ref):
    """The reduced recurrentgemma's forward in JAX itself, op by op
    (``jax.disable_jit``) against the reference (jitted, excess precision
    off): its logits leave the elementwise bf16 tolerance (XLA fuses the
    RG-LRU's gate math and rounds it otherwise), and stay within
    ``MODEL_RG`` — the tolerance admits JAX's own spread, no more."""
    arch = "recurrentgemma-2b"
    jcfg = jax_config(arch, reduced=True)
    jparams = jax_lm.init(jcfg, jax.random.PRNGKey(SEED))
    with jax_kernels.use_policy("backend=pallas"), jax.disable_jit():
        eager = np.asarray(jax_lm.forward(jparams, jcfg,
                                          jnp.asarray(recurrent_case()["dense"]))[0])
    want = ref[f"{arch}/forward"]
    assert not np.allclose(eager, want, rtol=2e-2, atol=2e-2)
    close_model(arch, torch.from_numpy(eager.copy()), want)


def test_prefill_and_decode_logits_match(model, ref):
    """A 13-token prefill (logits at rows 12 and 7: row 7 of the second
    sequence, as a bucketed prompt reads its last real token) into
    32-slot caches, then 8 one-token decode steps against them."""
    arch, cfg, _, params = model
    case = recurrent_case()
    logits, caches = lm.prefill(params, cfg, torch.from_numpy(case["prompt"]).long(),
                                cache_slots=32, logit_index=torch.tensor([12, 7]))
    close_model(arch, logits, ref[f"{arch}/prefill"])
    for i in range(8):
        logits, caches = lm.decode_step(params, cfg, caches,
                                        torch.from_numpy(case["steps"][:, i:i + 1]).long(),
                                        13 + i)
        close_model(arch, logits, ref[f"{arch}/decode{i}"])


def test_decode_returns_new_states_and_keeps_the_old(model):
    """``decode_step`` replaces recurrent states (a new list; the caller's
    states unchanged), so a step can be re-run on the same caches."""
    _, cfg, _, params = model
    caches = lm.init_cache(cfg, 2, 16, device="cpu")
    before = [tuple(x.clone() for x in c) for c in caches]
    tok = torch.tensor([[3], [5]])
    first, new = lm.decode_step(params, cfg, caches, tok, 0)
    again, _ = lm.decode_step(params, cfg, caches, tok, 0)
    assert torch.equal(first, again) and new is not caches
    for bd, c, b, n in zip(cfg.layer_defs, caches, before, new):
        if bd.mixer != "attn":
            assert all(torch.equal(x, y) for x, y in zip(c, b))
            assert not torch.equal(n.h, c.h)


# ---- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def served(ref):
    return json.loads(str(ref["serve_json"]))


def _port_stdout(params, args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        launcher.main([*args, "--device", "cpu"], params=params)
    return buf.getvalue()


@pytest.mark.parametrize("policy", DENSE_POLICIES)
def test_dense_server_streams_match_jax_launcher(model, served, policy):
    """Six prompts of 4-11 tokens (the reduced mamba2's chunk is 8, so
    some prefills pad), 8 new tokens each: the port's stdout equals the
    JAX launcher's, line for line, and no prompt is bucketed."""
    arch, cfg, _, params = model
    got = _port_stdout(params, [*recurrent_launch_args(arch), "--kernel-policy", policy])
    want = served["runs"][f"{arch} {policy}"]
    assert len([ln for ln in want.splitlines() if ln.startswith("req ")]) == 6
    assert got == want
    assert launcher.Server(cfg, params, device="cpu")._bucket is None


@pytest.mark.parametrize("ask", list(PAGED_ASKS))
def test_paged_serving_refuses_recurrent_archs_as_jax_does(model, served, ask):
    """``--kv paged`` and ``--server`` (paged by default) raise JAX's
    ``ValueError`` from the page pools; ``--spec-k`` without ``--kv paged``
    is JAX's usage error; with it, the pools' ``ValueError`` again."""
    arch, _, _, params = model
    want = served["errors"][f"{arch} {ask}"]
    args = [a for a in recurrent_launch_args(arch) if a not in ("--kv", "dense")] + PAGED_ASKS[ask]
    err = io.StringIO()
    with pytest.raises((ValueError, SystemExit)) as e, \
            contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        launcher.main([*args, "--device", "cpu"], params=params)
    assert [type(e.value).__name__, str(e.value)] == want[:2]
    if want[0] == "SystemExit":  # the parser's message, after its own prog name
        assert err.getvalue().strip().splitlines()[-1].split("error: ")[1] == \
            want[2].split("error: ")[1]


# ---- the window-16 recurrentgemma (rings that wrap, the banded path) ---------


@pytest.fixture(scope="module")
def w16():
    """The reduced recurrentgemma with window-16 local attention, on the
    reduced config's own parameters (a window has none)."""
    jparams = jax_lm.init(jax_config("recurrentgemma-2b", reduced=True), jax.random.PRNGKey(SEED))
    cfg = window16_config(get_config("recurrentgemma-2b", reduced=True))
    return cfg, from_jax_params(jax.device_get(jparams), device="cpu")


def test_window16_forward_takes_the_band(w16, ref):
    """300 tokens: both local layers band (window 16 + query chunk 256 <
    512 padded keys; bands of 384 keys)."""
    cfg, params = w16
    real, calls = memeff._banded, []

    def banded(*a, **kw):
        calls.append(kw["band"])
        return real(*a, **kw)

    with mock.patch.object(memeff, "_banded", banded):
        logits, _ = lm.forward(params, cfg, torch.from_numpy(recurrent_case()["long"]).long())
    assert calls == [384] * sum(bd.mixer == "attn" for bd in cfg.layer_defs)
    close_model(cfg.name, logits, ref["w16/forward300"])


@pytest.mark.parametrize("name,steps", [("24", 8), ("300", 4)])
def test_window16_prefill_rings_and_decode_match(w16, ref, name, steps):
    """A prompt longer than its 16-slot ring (24 tokens on the full path,
    300 on the banded one) leaves the last 16 positions, each at slot
    ``position % 16``; decode steps then wrap the ring."""
    cfg, params = w16
    case = recurrent_case()
    toks = torch.from_numpy(case["dense"] if name == "24" else case["long"]).long()
    b, s = toks.shape
    logits, caches = lm.prefill(params, cfg, toks, cache_slots=32,
                                logit_index=torch.full((b,), s - 1))
    close_model(cfg.name, logits, ref[f"w16/prefill{name}"])
    ring = caches[2]  # stage 0's local attention layer
    assert ring.pos[0].tolist() == [s - 16 + (i - s) % 16 for i in range(16)]
    if name == "24":  # ring.k[slot] holds position pos[slot]'s key
        np.testing.assert_array_equal(ring.pos.numpy(), ref["w16/ring24_pos"])
        close(ring.k, ref["w16/ring24_k"], torch.bfloat16)
    for i in range(steps):
        logits, caches = lm.decode_step(params, cfg, caches,
                                        torch.from_numpy(case["steps"][:b, i:i + 1]).long(),
                                        s + i)
        close_model(cfg.name, logits, ref[f"w16/decode{name}_{i}"])


class MarginSampler(GreedySampler):
    """Greedy, recording each choice's top-two logit margin and the row's
    largest |logit|, keyed by (rid, token index): an admission's row is
    the request admitted, a decode step's rows the server's slots."""

    def __init__(self):
        self.server, self.admitting, self.margins = None, None, {}

    def attach(self, server):
        admit = server._admit

        def admit_one(req):
            self.admitting = req
            try:
                return admit(req)
            finally:
                self.admitting = None

        self.server, server._admit = server, admit_one
        return server

    def select(self, logits):
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        margin, scale = (top2[:, 0] - top2[:, 1]).tolist(), logits[:, -1].abs().amax(-1).tolist()
        rows = {0: self.admitting} if self.admitting is not None else dict(self.server.active)
        for row, req in rows.items():
            self.margins[(req.rid, len(req.out))] = (margin[row], scale[row])
        return super().select(logits)


def test_window16_server_streams_match_jax(w16, served):
    """JAX's dense ``Server`` and the port's on the window-16 model: five
    prompts of 10-30 tokens, 12 new tokens each, so every ring wraps (the
    server's rings hold min(16, 256) slots).  Streams token-identical, but
    where the port's top-two margin at the first differing token is a
    near-tie (``NEAR_TIE``): request 3's 11th token, margin 0.0093 at max
    |logit| 0.70 (ROADMAP Queue 3)."""
    cfg, params = w16
    sampler = MarginSampler()
    done = sampler.attach(launcher.Server(cfg, params, sampler=sampler, device="cpu")).run(
        [Request(rid=r, prompt=p, max_new=m) for r, p, m in window16_requests()])
    want = served["runs"]["w16 server"]
    assert len(done) == len(want) == 5 and all(len(r.out) == 12 for r in done)
    differing = 0
    for r in done:
        if r.out == want[str(r.rid)]:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.out, want[str(r.rid)])) if a != b)
        margin, scale = sampler.margins[(r.rid, j)]
        assert margin <= NEAR_TIE * scale, (r.rid, j, margin, scale)
        differing += 1
    assert differing <= 1
