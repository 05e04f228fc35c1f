"""The port's int8 KV caches (``nn/kvquant.py``) against the JAX package's.

* ``quantize_kv`` is bit-equal to JAX's: the same int8 values and the
  same bf16 scales, on seeded numpy draws that include exact ties at .5
  (both round half to even) and all-zero rows;
* ``quant_decode_attention`` (the dense ring) and
  ``quant_paged_decode_attention`` (the page pool, through the
  paged-attention op: K3's plain version here, JAX's K3 in interpret mode
  there) on the same converted parameters and the same cache bytes;
* the int8 cold-prefill scatter, and the logits of a decode token and a
  5-token suffix over int8 pools, on the reduced qwen1.5-1.8b (a child
  process with XLA's excess precision off, ``_torch_jax_ref.py quant``);
* ``init_cache`` / ``init_paged_cache`` with ``"int8"`` and ``"f32"`` (the
  latter gives bf16, as in JAX) and ``cache_bytes``;
* ``PagedEngine(kv_dtype="int8")`` on the reduced qwen1.5-1.8b: token
  streams identical to JAX's ``PagedEngine`` with int8 pools, with and
  without ``prefill_chunk=4`` and a shared prefix, and with a pool small
  enough to preempt (int8 pages and their scales swapped out and back);
  each int8 stream is held to JAX's int8 stream, not to the bf16 one
  (``_torch_jax_ref.py int8serve``).

Tolerances: attention outputs and logits are compared at the bf16
tolerance of ``_torch_util.TOL`` (their activations are bf16; see
``test_torch_model.py``).  Page bytes quantised from K/V that the two
sides computed in other fp32 summation orders may round to the
neighbouring int8 step: they are held to one step, and all but a few to
equality."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import (
    INT8_RUNS,
    SEED,
    SPEC_SHAPE,
    SPEC_STATS,
    TARGET,
    model_case,
    params_checksum,
    serve_requests,
)
from _torch_util import close, jax_reference, t
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.nn import kvquant as jax_kvquant
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.nn import kvquant
from repro_torch.serve import PagedEngine, Request, ServeConfig
from repro_torch.weights import from_jax_params

LOGITS = torch.bfloat16  # tolerance class of attention outputs and logits


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine runs here are thousands of tiny ops: beside the suite's
    other workers, torch's default of one thread per core oversubscribes
    the CPU (a run that takes 1.4 s alone took 95 s in a whole run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(TARGET, reduced=True)
    jcfg = jax_config(TARGET, reduced=True)
    jparams = jax_lm.init(jcfg, jax.random.PRNGKey(SEED))
    return cfg, jcfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = jax_reference("quant", tmp_path_factory.mktemp("jax_quant"))
    assert float(out["params_checksum"]) == params_checksum(model[2])
    return out


def _draw(seed, shape, dtype):
    """Seeded K/V-like rows, with exact .5 ties and all-zero rows planted:
    a row whose max |x| is 127 has scale 127/127 + 1e-8 = 1.0 in fp32, so
    its half-integer entries land exactly on .5 after the division."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[0, 0] = 0.0  # all-zero rows: scale 1e-8, values 0
    ties = np.arange(shape[-1], dtype=np.float32) - shape[-1] / 2 + 0.5  # ..., -0.5, 0.5, ...
    x[0, 1] = ties
    x[0, 1, ..., 0] = 127.0
    x[-1, -1] = -ties
    x[-1, -1, ..., -1] = -127.0
    return jnp.asarray(x, {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_is_bit_equal_to_jax(dtype, seed):
    x = _draw(seed, (3, 5, 4, 32), dtype)
    wq, ws = jax_kvquant.quantize_kv(x)
    gq, gs = kvquant.quantize_kv(t(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.bfloat16
    assert gq.shape == (3, 5, 4, 32) and gs.shape == (3, 5, 4, 1)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.view(torch.int16).numpy(),
                                  np.asarray(ws).view(np.int16))  # the bf16 bits
    assert (gq[0, 0] == 0).all()  # the all-zero row
    # the planted ties round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    ties = np.asarray(x[0, 1, 0, 1:], np.float32)
    np.testing.assert_array_equal(gq[0, 1, 0, 1:].numpy(), np.round(ties))
    assert sorted({abs(v) % 1 for v in ties.tolist()}) == [0.5]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_dequantize_kv_matches_jax(out_dtype):
    wq, ws = jax_kvquant.quantize_kv(_draw(3, (2, 7, 2, 16), torch.bfloat16))
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[out_dtype]
    want = jax_kvquant.dequantize_kv(wq, ws, jdt)
    got = kvquant.dequantize_kv(t(wq), t(ws), out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_quantize_cache_matches_jax(model):
    from repro.nn.attention import KvCache as JaxKvCache
    from repro_torch.nn.attention import KvCache

    x = _draw(4, (2, 12, 4, 32), torch.bfloat16)
    pos = jnp.asarray(np.tile(np.arange(12, dtype=np.int32), (2, 1)))
    want = jax_kvquant.quantize_cache(JaxKvCache(k=x, v=-x, pos=pos))
    got = kvquant.quantize_cache(KvCache(k=t(x), v=t(-x), pos=t(pos)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def _attn_params(jparams, layer=0):
    return jax.tree.map(lambda a: a[layer], jparams["stage0"]["b0"]["attn"])


def test_quant_decode_attention_matches_jax(model):
    """Two tokens per slot at their own positions into int8 rings that
    hold a masked (-1) row and an empty slot row."""
    cfg, jcfg, jparams, params = model
    rng = np.random.default_rng(11)
    b, slots, s_new = 3, 12, 2
    kv, hd = cfg.attn.n_kv_heads, cfg.attn.head_dim
    kq, ks = jax_kvquant.quantize_kv(jnp.asarray(
        rng.standard_normal((b, slots, kv, hd)), jnp.bfloat16))
    vq, vs = jax_kvquant.quantize_kv(jnp.asarray(
        rng.standard_normal((b, slots, kv, hd)), jnp.bfloat16))
    pos = np.full((b, slots), -1, np.int32)
    pos[0, :7] = np.arange(7)
    pos[1, :4] = np.arange(4)
    pos[1, 2] = -1  # a masked bucket-padding row
    x = rng.standard_normal((b, s_new, cfg.d_model)).astype(np.float32)
    index = np.array([7, 4, 0], np.int32)
    jcache = jax_kvquant.QuantKvCache(k=kq, v=vq, k_scale=ks, v_scale=vs, pos=jnp.asarray(pos))
    with jax_kernels.use_policy("backend=pallas"):
        want, wcache = jax_kvquant.quant_decode_attention(
            _attn_params(jparams), jnp.asarray(x, jnp.bfloat16), jcache, jcfg.attn,
            index=jnp.asarray(index))
    cache = kvquant.QuantKvCache(*(t(a) for a in jcache))
    got, cache = kvquant.quant_decode_attention(
        params["layers"][0]["attn"], t(x).to(torch.bfloat16), cache, cfg.attn,
        index=torch.from_numpy(index))
    close(got, want, LOGITS)
    assert torch.equal(cache.pos, torch.from_numpy(np.array(wcache.pos)))
    # the new rows, quantised from K/V that agree to fp32 summation order
    diff = (cache.k.int() - torch.from_numpy(np.array(wcache.k)).int()).abs()
    assert int(diff.max()) <= 1
    close(cache.k_scale, wcache.k_scale, torch.bfloat16)


@pytest.mark.parametrize("s_new", [1, 5])
def test_quant_paged_decode_attention_matches_jax(model, s_new):
    """A decode token (s 1) and a verify-sized burst (s 5) into int8 pages
    through the paged-attention op (K3 in both packages), with a padded
    lane redirected to the null page."""
    cfg, jcfg, jparams, params = model
    rng = np.random.default_rng(12)
    kv, hd, ps, num_pages = cfg.attn.n_kv_heads, cfg.attn.head_dim, 8, 12
    kq, ks = jax_kvquant.quantize_kv(jnp.asarray(
        rng.standard_normal((kv, num_pages, ps, hd)), jnp.bfloat16))
    vq, vs = jax_kvquant.quantize_kv(jnp.asarray(
        rng.standard_normal((kv, num_pages, ps, hd)) * 4, jnp.bfloat16))
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
    index = np.array([17, 9, 0], np.int32)
    lengths = np.array([17 + s_new, 9 + s_new, 0], np.int32)  # lane 2 inactive
    x = rng.standard_normal((3, s_new, cfg.d_model)).astype(np.float32)
    jcache = jax_kvquant.QuantPagedKvCache(k_pages=kq, v_pages=vq, k_scale=ks, v_scale=vs)
    with jax_kernels.use_policy("backend=pallas"):
        want, wcache = jax_kvquant.quant_paged_decode_attention(
            _attn_params(jparams, 1), jnp.asarray(x, jnp.bfloat16), jcache, jcfg.attn,
            index=jnp.asarray(index), block_table=jnp.asarray(table),
            lengths=jnp.asarray(lengths))
    cache = kvquant.QuantPagedKvCache(*(t(a) for a in jcache))
    got, cache = kvquant.quant_paged_decode_attention(
        params["layers"][1]["attn"], t(x).to(torch.bfloat16), cache, cfg.attn,
        index=torch.from_numpy(index), block_table=torch.from_numpy(table),
        lengths=torch.from_numpy(lengths))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # plain path
    close(got[:2], np.asarray(want, np.float32)[:2], LOGITS)  # lane 2 has no keys
    live = slice(1, num_pages)  # the null page 0 takes padded writes: garbage by design
    diff = (cache.k_pages[:, live].int()
            - torch.from_numpy(np.array(wcache.k_pages[:, live])).int()).abs()
    assert int(diff.max()) <= 1
    close(cache.v_scale[:, live], np.asarray(wcache.v_scale[:, live], np.float32),
          torch.bfloat16)


def test_reference_params_are_these_params(model, ref):
    assert float(ref["params_checksum"]) == params_checksum(model[2])


def test_int8_cold_prefill_scatter_and_paged_logits_match(model, ref):
    """Cold prefills quantised into int8 pages, then one decode token and
    a 5-token suffix (K3's plain version, int8 on the gather)."""
    cfg, _, _, params = model
    case = model_case()
    paged = lm.init_paged_cache(cfg, 16, 8, "int8", device="cpu")
    for name, table in (("prompt_a", [1, 2, 3, 0]), ("prompt_b", [4, 5, 0, 0])):
        toks = case[name]
        padded = torch.zeros((1, 32), dtype=torch.long)
        padded[0, : len(toks)] = torch.from_numpy(toks)
        logits, dense = lm.prefill(params, cfg, padded, logit_index=len(toks) - 1)
        close(logits, ref[f"cold_{name}"], LOGITS)
        lm.prefill_to_pages(dense, paged, torch.tensor(table, dtype=torch.int32), len(toks))
    live = slice(1, 16)  # page 0 is the null page
    for i, layer in enumerate(paged):  # the reference stacks the layers
        for leaf in ("k_pages", "v_pages"):
            got = getattr(layer, leaf)[:, live].int()
            want = torch.from_numpy(ref[f"cold_{leaf}"][i, :, live]).int()
            diff = (got - want).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01, (i, leaf)
        for leaf in ("k_scale", "v_scale"):
            close(getattr(layer, leaf)[:, live], ref[f"cold_{leaf}"][i, :, live],
                  torch.bfloat16)
    table = torch.tensor([[1, 2, 3, 6, 0, 0, 0, 0], [4, 5, 7, 0, 0, 0, 0, 0]], dtype=torch.int32)
    logits, paged = lm.decode_step(params, cfg, paged, torch.from_numpy(case["step1"]).long(),
                                   torch.tensor([20, 11]), block_table=table,
                                   lengths=torch.tensor([21, 12], dtype=torch.int32))
    close(logits, ref["decode1"], LOGITS)
    logits, paged = lm.decode_step(params, cfg, paged, torch.from_numpy(case["step5"]).long(),
                                   torch.tensor([21, 12]), block_table=table,
                                   lengths=torch.tensor([26, 17], dtype=torch.int32))
    close(logits, ref["decode5"], LOGITS)
    diff = (paged[1].k_pages[:, live].int()
            - torch.from_numpy(ref["k_pages_layer1"][:, live]).int()).abs()
    assert int(diff.max()) <= 1
    close(paged[1].k_scale[:, live], ref["k_scale_layer1"][:, live], torch.bfloat16)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # plain path


def _leaves(tree):
    return [(np.dtype(a.dtype).name, tuple(a.shape)) for a in jax.tree.leaves(tree)]


_TORCH_DTYPE = {torch.int8: "int8", torch.bfloat16: "bfloat16", torch.int32: "int32"}


@pytest.mark.parametrize("kv_dtype", ["bf16", "f32", "int8"])
def test_init_caches_match_jax_leaves(model, kv_dtype):
    """The port's per-layer caches hold JAX's stacked leaves, layer by
    layer: int8 gives QuantKvCache / QuantPagedKvCache, "f32" bf16."""
    cfg, jcfg, _, _ = model
    dense = lm.init_cache(cfg, 2, 24, kv_dtype, device="cpu")
    paged = lm.init_paged_cache(cfg, 9, 8, kv_dtype, device="cpu")
    for got, want in ((dense, jax_lm.init_cache(jcfg, 2, 24, kv_dtype)),
                      (paged, jax_lm.init_paged_cache(jcfg, 9, 8, kv_dtype))):
        want_leaves = [(dt, shape[1:]) for dt, shape in _leaves(want)]  # unstack layers
        assert len(got) == cfg.n_layers
        for c in got:
            assert [(_TORCH_DTYPE[a.dtype], tuple(a.shape)) for a in c] == want_leaves
            assert type(c).__name__ == type(jax.tree.leaves(
                want, is_leaf=lambda x: hasattr(x, "_fields"))[0]).__name__
    quant = kv_dtype == "int8"
    assert isinstance(dense[0], kvquant.QuantKvCache) == quant
    assert isinstance(paged[0], kvquant.QuantPagedKvCache) == quant


def test_cache_bytes_match_jax(model):
    cfg, jcfg, _, _ = model
    for kv_dtype in ("bf16", "int8"):
        assert kvquant.cache_bytes(lm.init_paged_cache(cfg, 9, 8, kv_dtype, device="cpu")) \
            == jax_kvquant.cache_bytes(jax_lm.init_paged_cache(jcfg, 9, 8, kv_dtype))
        assert kvquant.cache_bytes(lm.init_cache(cfg, 2, 24, kv_dtype, device="cpu")) \
            == jax_kvquant.cache_bytes(jax_lm.init_cache(jcfg, 2, 24, kv_dtype))
    # int8 values + a bf16 scale per (row, head): (d + 2) / 2d of bf16's
    ratio = kvquant.cache_bytes(lm.init_paged_cache(cfg, 9, 8, "int8", device="cpu")) \
        / kvquant.cache_bytes(lm.init_paged_cache(cfg, 9, 8, device="cpu"))
    assert ratio == (cfg.attn.head_dim + 2) / (2 * cfg.attn.head_dim)


@pytest.fixture(scope="module")
def serve_ref(tmp_path_factory, model):
    out = jax_reference("int8serve", tmp_path_factory.mktemp("jax_int8serve"))
    assert float(out["params_checksum"]) == params_checksum(model[2])
    return json.loads(str(out["serve_json"]))


@pytest.mark.parametrize("run", list(INT8_RUNS))
def test_int8_streams_token_identical_to_jax_engine(model, serve_ref, run):
    cfg, _, _, params = model
    req_kw, eng_kw = INT8_RUNS[run]
    eng = PagedEngine(cfg, params, device="cpu", config=ServeConfig(**{**SPEC_SHAPE, **eng_kw}))
    done = eng.run([Request(rid=r, prompt=p, max_new=m) for r, p, m in serve_requests(**req_kw)])
    eng.check()  # the pool audit after swaps
    assert {str(r.rid): r.out for r in done} == serve_ref[run]["out"]
    assert all(len(r.out) == r.max_new for r in done)
    st = eng.stats()
    assert {k: st[k] for k in SPEC_STATS} == serve_ref[run]["stats"]
    if run.endswith("preempt"):
        assert st["preempted"] > 0
    elif not run.endswith("cold") and run != "bf16":
        assert st["prefix_hit_tokens"] > 0
    if eng_kw.get("kv_dtype") == "int8":
        assert isinstance(eng.caches[0], kvquant.QuantPagedKvCache)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # plain path


def test_int8_streams_agree_whatever_the_chunking(serve_ref):
    """JAX's own identity, which the port's streams inherit: chunked
    suffix prefill leaves the same int8 page bytes as one call."""
    assert serve_ref["int8_chunked"]["out"] == serve_ref["int8"]["out"]
