"""The port's model layer against the JAX package: the weight converter,
rmsnorm / rope / memeff op by op, and the logits of ``prefill`` and
``decode_step`` (dense and paged) of qwen1.5-0.5b ``reduced`` on the same
converted parameters.

The whole-model references run in a child process with XLA's excess
precision off (``_torch_jax_ref.py``), every kernel under the Pallas
backend; the port runs its plain CPU path.

Tolerance of the logits: they are fp32, but every activation before the
last matmul is bf16.  The two sides sum fp32 products in different
orders, so now and then a bf16 activation rounds to the other neighbour
of a tie, and that one bf16 ulp carries into the logits.  The logits are
therefore compared at the bf16 tolerance (``LOGITS``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import SEED, model_case, params_checksum
from _torch_util import close, jax_reference, t
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.nn.memeff import memeff_attention as jax_memeff
from repro.nn.module import rmsnorm as jax_rmsnorm
from repro.nn.module import rope as jax_rope
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.nn.memeff import memeff_attention
from repro_torch.nn.module import rmsnorm, rope
from repro_torch.nn.spec import tree_params
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


JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
LOGITS = torch.bfloat16  # tolerance class of the whole-model logits (see above)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return jax_reference("model", tmp_path_factory.mktemp("jax_model"))


def test_converter_round_trip(model):
    cfg, jparams, params = model
    h, kv, hd = cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim
    assert len(params["layers"]) == cfg.n_layers
    stacked = jparams["stage0"]["b0"]
    for i, layer in enumerate(params["layers"]):
        assert layer["attn"]["wq"].shape == (cfg.d_model, h * hd)
        assert layer["attn"]["wk"].shape == (cfg.d_model, kv * hd)
        assert layer["attn"]["wo"].shape == (h * hd, cfg.d_model)
        assert layer["attn"]["bq"].shape == (h * hd,)
        for path, leaf in (("attn/wq", layer["attn"]["wq"]), ("attn/wo", layer["attn"]["wo"]),
                           ("mlp/w_gate", layer["mlp"]["w_gate"]),
                           ("norm1/scale", layer["norm1"]["scale"])):
            a, b = path.split("/")
            want = np.asarray(stacked[a][b][i])
            assert leaf.dtype == {"bfloat16": torch.bfloat16,
                                  "float32": torch.float32}[want.dtype.name]
            assert leaf.is_contiguous()
            # bit-exact: the bf16 bytes cross through a uint16 view
            np.testing.assert_array_equal(leaf.float().numpy().reshape(want.shape),
                                          want.astype(np.float32))
    np.testing.assert_array_equal(params["embed"]["table"].float().numpy(),
                                  np.asarray(jparams["embed"]["table"], np.float32))
    # the port's own spec describes exactly the converted tree
    n = sum(x.numel() for x in jax.tree.leaves(
        [params["embed"], params["final_norm"], params["layers"]]))
    assert n == tree_params(lm.model_spec(cfg)) == cfg.params_count()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 5, 64)) * 4, JNP[dtype])
    scale = jnp.asarray(rng.standard_normal(64) * 0.1, jnp.float32)
    want = jax_rmsnorm({"scale": scale}, x)
    close(rmsnorm({"scale": t(scale)}, t(x)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_matches(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 7, 4, 16)), JNP[dtype])
    pos = jnp.asarray(rng.integers(0, 300, size=(2, 7)), jnp.int32)
    want = jax_rope(x, pos, theta=1_000_000.0)
    close(rope(t(x), t(pos), theta=1_000_000.0), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,kvh", [(24, 24, 4), (5, 48, 2), (16, 40, 1)])
def test_memeff_matches(dtype, sq, sk, kvh):
    """Key position -1 marks invalid slots; chunking pads keys with -1."""
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.standard_normal((2, sq, 4, 16)), JNP[dtype])
    k = jnp.asarray(rng.standard_normal((2, sk, kvh, 16)), JNP[dtype])
    v = jnp.asarray(rng.standard_normal((2, sk, kvh, 16)), JNP[dtype])
    qp = jnp.asarray(np.broadcast_to(np.arange(sk - sq, sk), (2, sq)), jnp.int32)
    kp = np.broadcast_to(np.arange(sk), (2, sk)).copy()
    kp[1, -3:] = -1  # empty cache slots
    kp = jnp.asarray(kp, jnp.int32)
    want = jax_memeff(q, k, v, qp, kp, softcap=30.0, qc=8, kc=16)
    got = memeff_attention(t(q), t(k), t(v), t(qp), t(kp), softcap=30.0, qc=8, kc=16)
    close(got, want)


def test_reference_params_are_these_params(model, ref):
    _, jparams, _ = model
    assert float(ref["params_checksum"]) == params_checksum(jparams)


def test_forward_and_prefill_logits_match(model, ref):
    cfg, _, params = model
    case = model_case()
    logits, aux = lm.forward(params, cfg, torch.from_numpy(case["dense"]).long())
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    close(logits, ref["forward"], LOGITS)
    sel, caches = lm.prefill(params, cfg, torch.from_numpy(case["dense"]).long(),
                             logit_index=torch.tensor([23, 9]))
    assert sel.shape == (2, 1, cfg.vocab) and len(caches) == cfg.n_layers
    close(sel, ref["prefill"], LOGITS)


def test_paged_decode_and_suffix_logits_match(model, ref):
    """Cold prefill scattered into pages, then one decode token (K2's plain
    version) and a 5-token suffix (K3's plain version) per sequence."""
    cfg, _, params = model
    case = model_case()
    paged = lm.init_paged_cache(cfg, 16, 8, device="cpu")
    for name, table in (("prompt_a", [1, 2, 3, 0]), ("prompt_b", [4, 5, 0, 0])):
        toks = case[name]
        padded = torch.zeros((1, 32), dtype=torch.long)
        padded[0, : len(toks)] = torch.from_numpy(toks)
        logits, dense = lm.prefill(params, cfg, padded, logit_index=len(toks) - 1)
        close(logits, ref[f"cold_{name}"], LOGITS)
        lm.prefill_to_pages(dense, paged, torch.tensor(table, dtype=torch.int32), len(toks))
    table = torch.tensor([[1, 2, 3, 6, 0, 0, 0, 0], [4, 5, 7, 0, 0, 0, 0, 0]], dtype=torch.int32)
    logits, paged = lm.decode_step(params, cfg, paged, torch.from_numpy(case["step1"]).long(),
                                   torch.tensor([20, 11]), block_table=table,
                                   lengths=torch.tensor([21, 12], dtype=torch.int32))
    close(logits, ref["decode1"], LOGITS)
    logits, paged = lm.decode_step(params, cfg, paged, torch.from_numpy(case["step5"]).long(),
                                   torch.tensor([21, 12]), block_table=table,
                                   lengths=torch.tensor([26, 17], dtype=torch.int32))
    close(logits, ref["decode5"], LOGITS)
    # the pages hold the same K rows (null page 0 is garbage by design)
    close(paged[2].k_pages[:, 1:], ref["k_pages_layer2"][:, 1:], torch.bfloat16)


def test_unsupported_config_features_raise():
    import dataclasses

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    # post-block norms are ported (tests/test_torch_families.py); a block
    # the JAX package cannot build either is refused by name
    spec = lm.model_spec(dataclasses.replace(cfg, post_block_norm=True))
    assert {"norm1_post", "norm2_post"} <= set(spec["layers"][0])
    with pytest.raises(ValueError, match="mixer=conv"):
        lm.model_spec(dataclasses.replace(cfg, stages=(((dataclasses.replace(
            cfg.stages[0][0][0], mixer="conv"),), cfg.n_layers),)))
    # int8 and f32 pools are ported (tests/test_torch_kvquant.py); a
    # kv_dtype no ServeConfig accepts is refused by name
    with pytest.raises(ValueError, match="kv_dtype"):
        lm.init_paged_cache(cfg, 4, 8, "fp8", device="cpu")


def test_untied_head_logits_match(tmp_path):
    """The untied head (B = ``unembed.w``, (d, vocab), as the full
    qwen1.5-1.8b has) on the reduced qwen1.5-1.8b made untied: JAX widens
    ``w`` to fp32 before the product, the port feeds it in bf16 (exact
    either way); the converted weights carry ``unembed.w`` bit for bit."""
    from _torch_jax_ref import TARGET, untied_config

    cfg = untied_config(get_config(TARGET, reduced=True))
    jparams = jax_lm.init(untied_config(jax_config(TARGET, reduced=True)),
                          jax.random.PRNGKey(SEED))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    ref = jax_reference("untied", tmp_path)
    assert float(ref["params_checksum"]) == params_checksum(jparams)
    w = params["unembed"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (cfg.d_model, cfg.vocab)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jparams["unembed"]["w"], np.float32))
    case = model_case()
    logits, _ = lm.forward(params, cfg, torch.from_numpy(case["dense"]).long())
    close(logits, ref["forward"], LOGITS)
    sel, _ = lm.prefill(params, cfg, torch.from_numpy(case["dense"]).long(),
                        logit_index=torch.tensor([23, 9]))
    close(sel, ref["prefill"], LOGITS)
