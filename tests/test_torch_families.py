"""The last model families of ``models/lm.py`` against the JAX package:
gemma2-9b (post-block norms on top of the softcaps, ``embed_scale`` and
local windows), command-r-35b (layernorm, GQA 8 : 1 at full width),
deepseek-7b (untied head, MHA), pixtral-12b (projected patch embeddings
prepended to the text) and whisper-medium as the JAX launcher serves it
(through ``models/lm.py``: layernorm, learned positions, no RoPE).

* ``layernorm`` and the post-block norms against JAX's, in process.
* The configs and the registry equal JAX's; the converter carries every
  new leaf (``pos``, ``frontend_proj``, ``norm1_post`` / ``norm2_post``,
  layernorm's ``bias``) bit for bit.
* ``forward``, a prefill (logits at given rows) and 4 decode steps of each
  reduced config, weights carried over by ``from_jax_params`` (JAX in a
  child process with excess precision off, ``_torch_jax_ref.py`` mode
  ``families``; every kernel under ``backend=pallas``).
* Learned positions as the JAX package adds them: rows ``0 .. s-1`` of
  the table for a call of ``s`` tokens, so a decode step adds row 0
  whatever its index (ROADMAP Queue 3 entry 20, matched).

* The launcher on pixtral-12b (text prompts) and whisper-medium: stdout
  equal to the JAX launcher's on ``--kv dense`` under the default,
  ``mcast`` and ``unicast`` policies (but at a recorded near-tie,
  ``hold_dense_streams``), and on ``--kv paged`` after a 24-token shared
  prefix.

The other archs' launcher runs are in ``test_torch_families_serve.py``
(two files, so that each one's JAX child stays short), whisper's
encoder-decoder in ``test_torch_encdec.py``.  Tolerances (``TOL`` in
``_torch_util.py``): bf16 outputs 2e-2 (two bf16 ulps: the two sides sum
fp32 products in other orders); fp32 norm outputs 1e-5; the logits of
every arch at the bf16 tolerance.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import (
    DENSE_POLICIES,
    FAMILY_ARCHS,
    FAMILY_SERVED,
    SEED,
    family_case,
    family_launch_args,
    params_checksum,
)
from _torch_util import MarginSampler, close, hold_dense_streams, jax_reference, port_launch, t
from repro import kernels as jax_kernels
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.nn import module as jax_module
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import encdec, lm
from repro_torch.nn import module
from repro_torch.nn.spec import init_params, tree_params
from repro_torch.weights import from_jax_params

#: full-width parameter counts, billions (2 bytes each in bf16)
FULL_PARAMS = {"gemma2-9b": 9.24, "command-r-35b": 30.28, "deepseek-7b": 6.91,
               "pixtral-12b": 12.25, "whisper-medium": 0.39}


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- configs and registry ----------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_configs_are_the_jax_configs(arch, reduced):
    want = dataclasses.asdict(jax_config(arch, reduced=reduced))
    assert dataclasses.asdict(get_config(arch, reduced=reduced)) == want


def test_registry_holds_the_jax_archs_and_every_model_builds():
    """The eleven archs, in JAX's order; ``lm.model_spec`` builds each
    (whisper-medium's decoder as the launcher serves it), and
    ``encdec.model_spec`` builds whisper-medium whole."""
    assert ARCHS == JAX_ARCHS and len(ARCHS) == 11
    for arch in ARCHS:
        assert tree_params(lm.model_spec(get_config(arch))) > 0
    assert tree_params(encdec.model_spec(get_config("whisper-medium"))) > 0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_full_width_parameter_counts_match_jax(arch):
    cfg = get_config(arch)
    assert cfg.params_count() == jax_config(arch).params_count()
    assert round(cfg.params_count() / 1e9, 2) == FULL_PARAMS[arch]


def test_block_specs_carry_the_post_norms_as_jax_does():
    """gemma2's blocks hold ``norm1_post`` and ``norm2_post``; a block
    without a feed-forward has no ``norm2_post``; layernorm blocks hold a
    ``bias`` beside each ``scale``."""
    cfg = get_config("gemma2-9b", reduced=True)
    jcfg = jax_config("gemma2-9b", reduced=True)
    for ff in ("mlp", "none"):
        bd = dataclasses.replace(cfg.layer_defs[0], ff=ff)
        jbd = dataclasses.replace(jcfg.layer_defs[0], ff=ff)
        assert list(lm.block_spec(cfg, bd)) == list(jax_lm.block_spec(jcfg, jbd))
    assert "norm2_post" not in lm.block_spec(cfg, dataclasses.replace(cfg.layer_defs[0],
                                                                      ff="none"))
    cr = get_config("command-r-35b", reduced=True)
    assert set(lm.block_spec(cr, cr.layer_defs[0])["norm1"]) == {"scale", "bias"}


# ---- layernorm and the post-block norms ----------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 1, 1024)], ids=["3x7x64", "2x1x1024"])
def test_layernorm_matches_jax(dtype, shape):
    """Mean and population variance in fp32, one rounding to the input's
    dtype; non-trivial scale and bias, and an input offset from zero."""
    rng = np.random.default_rng(shape[-1])
    x = jnp.asarray(rng.standard_normal(shape) * 3 + 1.5, dtype)
    params = {"scale": jnp.asarray(rng.standard_normal(shape[-1]), jnp.float32),
              "bias": jnp.asarray(rng.standard_normal(shape[-1]), jnp.float32)}
    want = jax.jit(jax_module.layernorm)(params, x)
    got = module.layernorm({k: t(v) for k, v in params.items()}, t(x))
    assert got.dtype == t(x).dtype and got.shape == shape
    close(got, want)


def test_layernorm_spec_is_jax_spec():
    """``scale`` ones and ``bias`` zeros, both fp32."""
    spec = module.layernorm_spec(8)
    jspec = jax_module.layernorm_spec(8)
    for name, init in (("scale", "ones"), ("bias", "zeros")):
        assert spec[name].init == jspec[name].init == init
        assert spec[name].dtype == torch.float32 and jspec[name].dtype == jnp.float32
    params = init_params(spec, seed=0, device="cpu")
    assert torch.equal(params["scale"], torch.ones(8))
    assert torch.equal(params["bias"], torch.zeros(8))


@pytest.fixture(scope="module")
def gemma2_block():
    """The reduced gemma2's first two layers (a window-16 layer and a
    global one), every norm scale drawn non-zero so the post norms shape
    the outputs; JAX's parameters and the port's."""
    jcfg, cfg = (jax_config("gemma2-9b", reduced=True), get_config("gemma2-9b", reduced=True))
    jcfg = dataclasses.replace(jcfg, n_layers=2, stages=((jcfg.stages[0][0], 1),))
    cfg = dataclasses.replace(cfg, n_layers=2, stages=((cfg.stages[0][0], 1),))
    jparams = jax_lm.init(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    for b in ("b0", "b1"):
        for norm in ("norm1", "norm1_post", "norm2", "norm2_post"):
            leaf = jparams["stage0"][b][norm]["scale"]
            jparams["stage0"][b][norm]["scale"] = jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.5, jnp.float32)
    return jcfg, cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


def test_post_block_norms_match_jax(gemma2_block):
    """The logits of both layers (the mixer output normed before its
    residual add, the feed-forward output too) against JAX's forward on the
    same weights, op by op (``jax.disable_jit``: this process keeps XLA's
    excess precision, which a jitted forward would use between bf16 ops);
    and the post norms change the result."""
    jcfg, cfg, jparams, params = gemma2_block
    tokens = np.random.default_rng(6).integers(0, 512, size=(2, 20)).astype(np.int32)
    with jax_kernels.use_policy("backend=pallas"), jax.disable_jit():
        want = jax_lm.forward(jparams, jcfg, jnp.asarray(tokens))[0]
    got, _ = lm.forward(params, cfg, torch.from_numpy(tokens).long())
    close(got, want, torch.bfloat16)
    bare = dict(params, layers=[{k: v for k, v in layer.items() if not k.endswith("_post")}
                                for layer in params["layers"]])
    without, _ = lm.forward(bare, cfg, torch.from_numpy(tokens).long())
    assert not torch.allclose(without, got, rtol=2e-2, atol=2e-2)


# ---- the models ----------------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def model(request):
    arch = request.param
    jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
    return arch, get_config(arch, reduced=True), jparams, from_jax_params(
        jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("families", tmp_path_factory.mktemp("jax_families"))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converter_carries_the_new_leaves(model):
    """``pos``, ``frontend_proj``, the post norms and layernorm's ``bias``
    (in every layer and the final norm) arrive bit for bit, in their
    dtypes; the port's spec describes exactly the converted tree."""
    arch, cfg, jparams, params = model
    new = {"pos", "frontend_proj", "final_norm"}
    for path, val in _leaves({k: v for k, v in params.items() if k in new}):
        want = jparams
        for k in path:
            want = want[k]
        want = np.asarray(want)
        assert str(val.dtype).endswith(want.dtype.name), path
        np.testing.assert_array_equal(val.float().numpy(), want.astype(np.float32))
    stage = jparams["stage0"]
    for i, layer in enumerate(params["layers"]):
        block = stage[f"b{i % len(stage)}"]
        r = i // len(stage)
        for name in ("norm1", "norm1_post", "norm2", "norm2_post"):
            if name in block:
                for leaf, val in layer[name].items():
                    np.testing.assert_array_equal(val.numpy(), np.asarray(block[name][leaf][r]))
    assert ("pos" in params) == cfg.attn.learned_pos
    assert ("frontend_proj" in params) == bool(cfg.frontend)
    assert ("norm1_post" in params["layers"][0]) == cfg.post_block_norm
    assert ("bias" in params["final_norm"]) == (cfg.norm == "layernorm")
    n = sum(v.numel() for _, v in _leaves(dict(params, layers={
        str(i): lyr for i, lyr in enumerate(params["layers"])})))
    assert n == tree_params(lm.model_spec(cfg)) == cfg.params_count()


def test_reference_params_are_these_params(model, ref):
    arch, _, jparams, _ = model
    assert float(ref[f"{arch}/params_checksum"]) == params_checksum(jparams)


def _patches(cfg):
    """pixtral's seeded patch embeddings (bf16), else None."""
    if cfg.frontend != "vision":
        return None
    return t(family_case()["patches"])


def test_forward_logits_match(model, ref):
    """24 tokens, batch 2 (pixtral: 6 projected patches first, 30 rows)."""
    arch, cfg, _, params = model
    fe = _patches(cfg)
    logits, aux = lm.forward(params, cfg, torch.from_numpy(family_case()["dense"]).long(),
                             frontend_embeds=fe)
    n = 0 if fe is None else fe.shape[1]
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert logits.shape == (2, n + 24, cfg.vocab)
    close(logits, ref[f"{arch}/forward"], torch.bfloat16)


def test_prefill_and_decode_logits_match(model, ref):
    """A 13-token prefill (pixtral: after its 6 patches) into 32-slot
    caches, logits at each sequence's rows ``n + 12`` and ``n + 7``, then 4
    one-token decode steps (gemma2's 16-slot local rings wrap)."""
    arch, cfg, _, params = model
    case, fe = family_case(), _patches(cfg)
    n = 0 if fe is None else fe.shape[1]
    logits, caches = lm.prefill(params, cfg, torch.from_numpy(case["prompt"]).long(),
                                frontend_embeds=fe, cache_slots=32,
                                logit_index=torch.tensor([n + 12, n + 7]))
    close(logits, ref[f"{arch}/prefill"], torch.bfloat16)
    for i in range(case["steps"].shape[1]):
        logits, caches = lm.decode_step(params, cfg, caches,
                                        torch.from_numpy(case["steps"][:, i:i + 1]).long(),
                                        n + 13 + i)
        close(logits, ref[f"{arch}/decode{i}"], torch.bfloat16)


def test_frontend_embeds_are_projected_and_prepended():
    """pixtral's input rows: the patches through ``frontend_proj`` (K1),
    then the token embeddings; no position table."""
    cfg = get_config("pixtral-12b", reduced=True)
    params = lm.init(cfg, seed=0, device="cpu")
    fe, tokens = _patches(cfg), torch.from_numpy(family_case()["prompt"]).long()
    x = lm._embed_inputs(params, cfg, tokens, fe)
    assert x.shape == (2, fe.shape[1] + tokens.shape[1], cfg.d_model)
    assert torch.equal(x[:, :fe.shape[1]], module.dense(params["frontend_proj"], fe))
    assert torch.equal(x[:, fe.shape[1]:], params["embed"]["table"][tokens])


def test_learned_positions_add_the_rows_of_the_call(ref):
    """whisper-medium through ``models/lm.py``: a call of ``s`` tokens adds
    rows ``0 .. s-1`` of the position table, whatever the tokens' absolute
    positions — a decode step at index 13 adds row 0, as the JAX package's
    does (its decode logits with every other row zeroed are the same).
    ROADMAP Queue 3 entry 20: recorded, matched."""
    arch = "whisper-medium"
    jparams = jax_lm.init(jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))
    cfg, params = get_config(arch, reduced=True), from_jax_params(jax.device_get(jparams),
                                                                   device="cpu")
    table = params["pos"]["table"]
    rows0 = dict(params, pos={"table": torch.zeros_like(table)})
    rows0["pos"]["table"][0] = table[0]
    case = family_case()
    prompt = torch.from_numpy(case["prompt"]).long()
    _, caches = lm.prefill(params, cfg, prompt, cache_slots=32)
    _, caches0 = lm.prefill(params, cfg, prompt, cache_slots=32)
    for i in range(case["steps"].shape[1]):
        tok = torch.from_numpy(case["steps"][:, i:i + 1]).long()
        logits, caches = lm.decode_step(params, cfg, caches, tok, 13 + i)
        logits0, caches0 = lm.decode_step(rows0, cfg, caches0, tok, 13 + i)
        assert torch.equal(logits, logits0)
        close(logits0, ref[f"{arch}/decode_rows0_{i}"], torch.bfloat16)
        np.testing.assert_array_equal(ref[f"{arch}/decode_rows0_{i}"], ref[f"{arch}/decode{i}"])


# ---- the launcher on pixtral-12b and whisper-medium ---------------------------


@pytest.mark.parametrize("policy", DENSE_POLICIES)
@pytest.mark.parametrize("arch", FAMILY_SERVED["families"])
def test_dense_server_streams_match_jax_launcher(model_params, ref, arch, policy):
    """Six requests after a 24-token shared prefix (bucketed prefills), 8
    new tokens each: the port's stdout equals the JAX launcher's."""
    sampler = MarginSampler()
    got = port_launch(model_params[arch], [*family_launch_args(arch), "--kv", "dense",
                                           "--kernel-policy", policy], sampler)
    runs = json.loads(str(ref["serve_json"]))["runs"]
    hold_dense_streams(got, runs[f"{arch} dense {policy}"], sampler.margins)


@pytest.mark.parametrize("arch", FAMILY_SERVED["families"])
def test_paged_streams_match_jax_launcher(model_params, ref, arch):
    """``--kv paged`` after the shared prefix (prefix hits, suffix prefills
    — whisper's add position rows 0 .. s-1 of each call, as JAX's do): the
    JAX launcher's stdout."""
    got = port_launch(model_params[arch], [*family_launch_args(arch), "--kv", "paged",
                                           "--kernel-policy", "backend=pallas"])
    assert got == json.loads(str(ref["serve_json"]))["runs"][f"{arch} paged"]


@pytest.fixture(scope="module")
def model_params():
    """The JAX launcher's seeded parameters of the served archs, converted."""
    return {arch: from_jax_params(jax.device_get(jax_lm.init(
        jax_config(arch, reduced=True), jax.random.PRNGKey(SEED))), device="cpu")
        for arch in FAMILY_SERVED["families"]}
