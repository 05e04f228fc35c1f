"""whisper-medium's encoder-decoder (``models/encdec.py``) against the JAX
package's, at the reduced config (2 + 2 layers, d 64, 24 frames of 32).

* Bidirectional self-attention and cross attention against JAX's, in
  process (op by op: this process keeps XLA's excess precision).
* The converter: every leaf of ``encoder.stage`` / ``decoder.stage`` split
  per layer bit for bit (``self_attn`` / ``cross_attn`` made 2-D), the
  other leaves carried; the port's spec describes exactly that tree.
* Every encoder layer and the decoder's blocks against JAX's on the same
  inputs, at the bf16 tolerance (in process, op by op).
* ``encode``, ``forward`` and a prefill into 16-slot rings against JAX
  (``_torch_jax_ref.py`` mode ``encdec``, a child process with excess
  precision off, every kernel under ``backend=pallas``), held to
  ``WITNESS``; 4 decode steps at a ragged (batch,) index from JAX's
  prefill caches at the bf16 tolerance.  The prefill's cross attention is
  the blockwise ``memeff_attention``, a decode step's the dense
  ``_attend``, in both packages.
* An 8-token greedy stream, token for token.

Tolerances (``TOL`` in ``_torch_util.py``): bf16 outputs 2e-2 (two bf16
ulps), the logits at the bf16 tolerance where both sides start from the
same inputs.  Whole runs from the frames are held to ``WITNESS``: the
largest gap may be at most a quarter of the gap that one flipped last bit
of the frames opens in JAX itself (measured: 0.03 of it for ``encode``,
0.14 for ``forward``, 0.06 for the prefill).  The reduced config's random weights
make attention nearly one-hot (q and k reach |19|), so the last-bit
differences of the two sides' ``exp`` (XLA's and torch's, one bf16 ulp in
a few attention outputs of layer 0) grow through the stack: about 1.6 %
of the largest encoder output and 3-8 % of the largest logit, where a
flipped input ulp moves JAX's own by 56-57 %.  Every layer on the same
inputs, and every decode step on the same caches, stays within the bf16
tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import ENCDEC_ARCH, SEED, encdec_case, encdec_greedy, params_checksum
from _torch_util import close, jax_reference, t
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.models import encdec as jax_encdec
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attn
from repro.nn.spec import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import encdec, lm
from repro_torch.nn import attention as attn
from repro_torch.nn.attention import KvCache
from repro_torch.nn.spec import tree_params
from repro_torch.weights import from_jax_encdec_params


WITNESS = 0.25  # a whole run's gap over the gap one flipped input ulp opens in JAX


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config(ENCDEC_ARCH, reduced=True)
    jparams = jax_encdec.init(jcfg, jax.random.PRNGKey(SEED))
    return (get_config(ENCDEC_ARCH, reduced=True), jparams,
            from_jax_encdec_params(jax.device_get(jparams), device="cpu"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("encdec", tmp_path_factory.mktemp("jax_encdec"))


# ---- attention -------------------------------------------------------------------


def _attn_pair(seed):
    cfg = get_config(ENCDEC_ARCH, reduced=True)
    jcfg = jax_config(ENCDEC_ARCH, reduced=True)
    jparams = jax_init_params(jax_attn.attn_spec(jcfg.d_model, jcfg.attn), jax.random.PRNGKey(seed))
    d = cfg.d_model
    params = {k: t(v).reshape(d, -1) if k != "wo" else t(v).reshape(-1, d)
              for k, v in jparams.items()}
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("s", [5, 24, 37])
def test_bidirectional_attention_matches_jax(s):
    """``attention(causal=False)``: every position sees every other (no
    RoPE for whisper), at lengths the query chunk does and does not divide."""
    cfg, jcfg, jparams, params = _attn_pair(s)
    x = jnp.asarray(np.random.default_rng(s).standard_normal((2, s, cfg.d_model)), jnp.bfloat16)
    with jax_kernels.use_policy("backend=pallas"), jax.disable_jit():
        want = jax_attn.attention(jparams, x, jcfg.attn, causal=False)
    got, (k, v) = attn.attention(params, t(x), cfg.attn, causal=False)
    close(got, want)
    assert k.shape == v.shape == (2, s, cfg.attn.n_kv_heads, cfg.attn.head_dim)
    causal, _ = attn.attention(params, t(x), cfg.attn)
    assert not torch.allclose(causal[:, :-1], got[:, :-1], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s,frames", [(1, 24), (7, 24), (9, 50)])
def test_cross_attention_matches_jax(s, frames):
    """Queries from the decoder, keys and values from the encoder's
    output, every frame visible."""
    cfg, jcfg, jparams, params = _attn_pair(s + frames)
    rng = np.random.default_rng(frames)
    x = jnp.asarray(rng.standard_normal((2, s, cfg.d_model)), jnp.bfloat16)
    mem = jnp.asarray(rng.standard_normal((2, frames, cfg.d_model)), jnp.bfloat16)
    with jax_kernels.use_policy("backend=pallas"), jax.disable_jit():
        want = jax_attn.cross_attention(jparams, x, mem, jcfg.attn)
    got, (k, _) = attn.cross_attention(params, t(x), t(mem), cfg.attn)
    close(got, want)
    assert k.shape == (2, frames, cfg.attn.n_kv_heads, cfg.attn.head_dim)


# ---- the model ---------------------------------------------------------------------


def test_model_spec_and_full_width_count_match_jax():
    """The same leaves as JAX's spec (its stacks split per layer), and the
    full width's 0.79 B parameters (1.6 GB of bf16)."""
    for reduced in (False, True):
        cfg, jcfg = get_config(ENCDEC_ARCH, reduced=reduced), jax_config(ENCDEC_ARCH,
                                                                         reduced=reduced)
        jn = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
            jax_encdec.model_spec(jcfg), is_leaf=lambda x: hasattr(x, "shape")))
        assert tree_params(encdec.model_spec(cfg)) == jn
    assert round(tree_params(encdec.model_spec(get_config(ENCDEC_ARCH))) / 1e9, 2) == 0.79
    with pytest.raises(ValueError, match="no encoder"):
        encdec.model_spec(get_config("command-r-35b", reduced=True))


def test_converter_splits_both_stacks(model):
    """Layer i of ``encoder.layers`` / ``decoder.layers`` is repeat i of
    JAX's stacked leaves, bit for bit; headed projections 2-D."""
    cfg, jparams, params = model
    d = cfg.d_model
    for side, n in (("encoder", cfg.encoder.n_layers), ("decoder", cfg.n_layers)):
        assert len(params[side]["layers"]) == n
        stage = jparams[side]["stage"]
        for i, layer in enumerate(params[side]["layers"]):
            for block, leaves in layer.items():
                for name, val in leaves.items():
                    want = np.asarray(stage[block][name][i], np.float32)
                    if name in ("wq", "wk", "wv"):
                        want = want.reshape(d, -1)
                    elif name == "wo":
                        want = want.reshape(-1, d)
                    np.testing.assert_array_equal(val.float().numpy(), want)
        for key in ("pos", "final_norm"):
            for name, val in params[side][key].items():
                np.testing.assert_array_equal(val.float().numpy(),
                                              np.asarray(jparams[side][key][name], np.float32))
    np.testing.assert_array_equal(params["encoder"]["proj"]["w"].float().numpy(),
                                  np.asarray(jparams["encoder"]["proj"]["w"], np.float32))
    n = sum(v.numel() for v in jax.tree.leaves(params))
    assert n == tree_params(encdec.model_spec(cfg))
    spec = encdec.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda v: (tuple(v.shape), v.dtype), spec) == \
        jax.tree.map(lambda v: (tuple(v.shape), v.dtype), params)


def test_reference_params_are_these_params(model, ref):
    _, jparams, _ = model
    assert float(ref["params_checksum"]) == params_checksum(jparams)


def _inputs():
    case = encdec_case()
    return case, t(case["frames"]), torch.from_numpy(case["tokens"]).long()


def hold_witness(got: torch.Tensor, ref, name: str) -> None:
    """``got`` within ``WITNESS`` x the gap between JAX's ``name`` and its
    run on the flipped frames."""
    want, flipped = np.asarray(ref[name], np.float32), np.asarray(ref[f"{name}_flipped"],
                                                                    np.float32)
    gap, spread = np.abs(got.float().numpy() - want).max(), np.abs(flipped - want).max()
    assert spread > 0 and gap <= WITNESS * spread, (name, gap, spread)


def test_encoder_and_decoder_layers_match_jax(model):
    """Each encoder layer, then each decoder block (self attention, cross
    attention over JAX's memory, MLP) on JAX's own inputs, at the bf16
    tolerance; JAX op by op."""
    cfg, jparams, params = model
    case = encdec_case()
    jcfg = jax_config(ENCDEC_ARCH, reduced=True)
    with jax_kernels.use_policy("backend=pallas"), jax.disable_jit():
        jx = jax_kernels.linear(jnp.asarray(case["frames"]), jparams["encoder"]["proj"]["w"],
                                out_dtype=jnp.bfloat16)
        jx = jx + jparams["encoder"]["pos"]["table"][:24][None].astype(jx.dtype)
        for i, layer in enumerate(params["encoder"]["layers"]):
            bp = jax.tree.map(lambda a: a[i], jparams["encoder"]["stage"])
            h = jax_lm._norm(jcfg, bp["norm1"], jx)
            jy = jx + jax_attn.attention(bp["attn"], h, jcfg.attn, causal=False)
            jy = jy + jax_lm.mlp(bp["mlp"], jax_lm._norm(jcfg, bp["norm2"], jy), jcfg)
            x = t(jx)
            y = x + attn.attention(layer["attn"], lm._norm(cfg, layer["norm1"], x), cfg.attn,
                                   causal=False)[0]
            y = y + lm.mlp(layer["mlp"], lm._norm(cfg, layer["norm2"], y), cfg)
            close(y, jy)
            jx = jy
        memory = jax_lm._norm(jcfg, jparams["encoder"]["final_norm"], jx)
        jx = jax_encdec._dec_embed(jparams, jcfg, jnp.asarray(case["tokens"]))
        for i, layer in enumerate(params["decoder"]["layers"]):
            bp = jax.tree.map(lambda a: a[i], jparams["decoder"]["stage"])
            x = t(jx)
            for name, norm, jfn, fn in (
                    ("self_attn", "norm1",
                     lambda p, h: jax_attn.attention(p, h, jcfg.attn, causal=True),
                     lambda p, h: attn.attention(p, h, cfg.attn, causal=True)[0]),
                    ("cross_attn", "norm_x",
                     lambda p, h: jax_attn.cross_attention(p, h, memory, jcfg.attn),
                     lambda p, h: attn.cross_attention(p, h, t(memory), cfg.attn)[0]),
                    ("mlp", "norm2", lambda p, h: jax_lm.mlp(p, h, jcfg),
                     lambda p, h: lm.mlp(p, h, cfg))):
                jy = jx + jfn(bp[name], jax_lm._norm(jcfg, bp[norm], jx))
                close(t(jx) + fn(layer[name], lm._norm(cfg, layer[norm], t(jx))), jy)
                jx = jy
            assert x.shape == t(jx).shape


def test_encode_matches(model, ref):
    """24 frames through the projection (K1, bf16 out), learned positions
    and 2 bidirectional layers."""
    cfg, _, params = model
    _, frames, _ = _inputs()
    memory = encdec.encode(params, cfg, frames)
    assert memory.dtype == torch.bfloat16 and memory.shape == (2, 24, cfg.d_model)
    hold_witness(memory, ref, "encode")


def test_forward_matches(model, ref):
    cfg, _, params = model
    _, frames, tokens = _inputs()
    logits, aux = encdec.forward(params, cfg, tokens, frames)
    assert logits.dtype == torch.float32 and logits.shape == (2, 7, cfg.vocab)
    assert float(aux) == 0.0
    hold_witness(logits, ref, "forward")


def test_prefill_matches_and_builds_its_caches(model, ref):
    """A 7-token prefill into 16-slot rings: its last logits, rings holding
    positions 0-6, and cross keys and values projected from the memory."""
    cfg, _, params = model
    _, frames, tokens = _inputs()
    logits, caches = encdec.prefill(params, cfg, tokens, frames, cache_slots=16)
    hold_witness(logits, ref, "prefill")
    assert all(c.k.shape[1] == 16 for c in caches["self"])
    assert caches["self"][0].pos[0].tolist() == list(range(7)) + [-1] * 9
    memory = encdec.encode(params, cfg, frames)
    layer = params["decoder"]["layers"][1]["cross_attn"]
    assert torch.equal(caches["cross"][1].k.flatten(2),
                       attn.kernels.linear(memory, layer["wk"]))
    assert caches["cross"][1].k.shape == tuple(ref["cache_cross_k"].shape[1:])


def test_ragged_decode_from_jax_caches_matches(model, ref):
    """4 decode steps from JAX's prefill caches, row 1 three positions
    behind row 0 (``index`` (batch,)), each at the bf16 tolerance; the
    rings updated in place."""
    cfg, _, params = model
    case = encdec_case()
    caches = {
        "self": [KvCache(k=t(ref["cache_self_k"][i]).bfloat16(),
                         v=t(ref["cache_self_v"][i]).bfloat16(),
                         pos=t(ref["cache_self_pos"][i]).int()) for i in range(cfg.n_layers)],
        "cross": [encdec.CrossKv(k=t(ref["cache_cross_k"][i]).bfloat16(),
                                 v=t(ref["cache_cross_v"][i]).bfloat16())
                  for i in range(cfg.n_layers)]}
    for i in range(case["steps"].shape[1]):
        logits, caches = encdec.decode_step(params, cfg, caches,
                                            torch.from_numpy(case["steps"][:, i:i + 1]).long(),
                                            torch.from_numpy(case["index"] + i))
        close(logits, ref[f"decode{i}"], torch.bfloat16)
    assert caches["self"][0].pos[1, 4:8].tolist() == [4, 5, 6, 7]


def test_greedy_stream_matches(model, ref):
    """8 greedy tokens a row, from the same prefill and ragged index."""
    cfg, _, params = model
    case = encdec_case()

    def asarray(a):
        return t(a) if getattr(a, "dtype", None) is not None and a.dtype.name == "bfloat16" \
            else torch.from_numpy(np.asarray(a)).long()

    got = encdec_greedy(encdec, params, cfg, case, 8, asarray)
    np.testing.assert_array_equal(got, ref["greedy"])


def test_cache_spec_allocates_nothing():
    """Per decoder layer a ``cache_len``-slot ring and the frames' cross
    keys and values, as JAX's ``cache_spec`` shapes them (stacked there)."""
    cfg, jcfg = get_config(ENCDEC_ARCH), jax_config(ENCDEC_ARCH)
    spec = encdec.cache_spec(cfg, 2, 448)
    want = jax_encdec.cache_spec(jcfg, 2, 448)
    assert len(spec["self"]) == len(spec["cross"]) == cfg.n_layers
    for got, w in ((spec["self"][0], want["self"]), (spec["cross"][0], want["cross"])):
        for a, b in zip(got, w):
            assert a.device.type == "meta" and tuple(a.shape) == tuple(b.shape[1:])
            assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name.replace(
                "bfloat16", "bfloat16")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
