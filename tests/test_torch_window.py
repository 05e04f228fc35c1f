"""The port's local-window attention against the JAX package: the window
mask of memeff's full path, the banded path (``_banded``, its band start
clamped as JAX's ``dynamic_slice`` clamps it), ``decode_attention`` and
the int8 ring's ``quant_decode_attention`` across a ring's wrap, the ring
layout a prefill longer than its ring leaves (``_kv_from_full``), the
dense rings' mask at its edges, and the page pools' refusal of windowed
archs.  Everything runs in process, JAX under
``backend=pallas`` (interpret mode); the whole window-16 model and its
``Server`` are held in ``tests/test_torch_recurrent.py`` (one JAX child).

The models' reduced recurrentgemma keeps its 2048-token window, so
nothing wraps at reduced sizes: these tests build small windows (8-100)
and a window-16 variant of the reduced config.

Tolerance: bf16 outputs at ``TOL`` (2e-2, two bf16 ulps: fp32 sums in
other orders); positions, ring slots and masks exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_ref import SEED, window16_config
from _torch_util import close, t
from repro import kernels as jax_kernels
from repro.configs import base as jax_base
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attention
from repro.nn import kvquant as jax_kvquant
from repro.nn.memeff import memeff_attention as jax_memeff
from repro_torch.configs import base
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.nn import attention, kvquant
from repro_torch.nn.memeff import memeff_attention
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- memeff ------------------------------------------------------------------

#: (name, sq, h, kvh, window, qc, kc, softcap); ``full``: window + qc >= the
#: padded keys, so the full path masks by the window; the others band
MEMEFF_CASES = [
    ("full", 48, 4, 2, 40, 16, 16, None),
    ("full-softcap", 48, 4, 1, 20, 32, 16, 30.0),
    ("banded", 400, 4, 2, 8, 16, 32, None),
    ("banded-mqa-softcap", 300, 4, 1, 100, 64, 1024, 30.0),
    ("banded-default-chunks", 300, 2, 2, 16, 512, 1024, None),
]


def _takes_band(sq, window, qc, kc):
    """JAX's rule, from its chunk sizes: band where window + qc < padded sk."""
    p2 = lambda n: 1 << (n.bit_length() - 1)  # noqa: E731
    qc, kc = min(qc, p2(sq)), min(kc, p2(sq))
    return window + qc < -(-sq // kc) * kc


@pytest.mark.parametrize("name,sq,h,kvh,window,qc,kc,softcap", MEMEFF_CASES,
                         ids=[c[0] for c in MEMEFF_CASES])
def test_memeff_window_matches_jax(name, sq, h, kvh, window, qc, kc, softcap):
    """Causal self-attention with a local window: the full path with the
    window in its mask, and the banded path (bands of round_up(window +
    qc, 128) keys; at 400 tokens in chunks of 16 the band start is
    clamped at both ends)."""
    assert _takes_band(sq, window, qc, kc) == name.startswith("banded")
    rng = np.random.default_rng(sq + window)
    q = jnp.asarray(rng.standard_normal((2, sq, h, 16)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((2, sq, kvh, 16)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((2, sq, kvh, 16)), jnp.bfloat16)
    pos = jnp.asarray(np.broadcast_to(np.arange(sq), (2, sq)), jnp.int32)
    kw = dict(window=window, softcap=softcap, qc=qc, kc=kc)
    want = jax_memeff(q, k, v, pos, pos, **kw)
    got = memeff_attention(t(q), t(k), t(v), t(pos), t(pos), **kw)
    assert got.shape == (2, sq, h, 16) and got.dtype == torch.bfloat16
    close(got, want)
    # the window matters: the unwindowed result differs
    assert not torch.equal(got, memeff_attention(t(q), t(k), t(v), t(pos), t(pos), softcap=softcap,
                                                 qc=qc, kc=kc))


def test_banded_equals_full_with_the_window_mask():
    """The band drops only keys the window masks: banded and full paths
    agree (different softmax chunkings, so at bf16 tolerance)."""
    rng = np.random.default_rng(4)
    sq = 400
    q, k, v = (torch.from_numpy(rng.standard_normal((1, sq, 2, 16)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    pos = torch.arange(sq)[None]
    banded = memeff_attention(q, k, v, pos, pos, window=8, qc=16, kc=32)
    full = memeff_attention(q, k, v, pos, pos, window=8, qc=512, kc=512)  # window + qc >= sk
    close(banded, full.float(), torch.bfloat16)


# ---- decode across a ring wrap -----------------------------------------------

ATTN = dict(n_heads=4, n_kv_heads=1, head_dim=16)
D = 32


@pytest.fixture(scope="module")
def attn_pair():
    from repro.nn.spec import init_params

    jcfg, cfg = jax_base.AttnConfig(**ATTN), base.AttnConfig(**ATTN)
    jparams = init_params(jax_attention.attn_spec(D, jcfg), jax.random.PRNGKey(3))
    params = {"wq": t(jparams["wq"]).reshape(D, -1), "wk": t(jparams["wk"]).reshape(D, -1),
              "wv": t(jparams["wv"]).reshape(D, -1), "wo": t(jparams["wo"]).reshape(-1, D)}
    return jparams, params, jcfg, cfg


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_decode_attention_across_a_ring_wrap(attn_pair, kv_dtype):
    """An 8-slot ring under a window of 8, fed 20 tokens for 3 sequences at
    their own positions (0, 3 and 9 tokens ahead), one or two tokens a
    call: every call's output, and the ring's positions after it, equal
    JAX's — positions wrap to slot ``position % 8`` and a key leaves the
    window as its slot is overwritten."""
    jparams, params, jcfg, cfg = attn_pair
    rng = np.random.default_rng(9)
    b, slots, window = 3, 8, 8
    start = np.array([0, 3, 9], np.int32)
    if kv_dtype == "int8":
        jcache = jax_kvquant.init_quant_cache(b, slots, jcfg)
        cache = kvquant.init_quant_cache(b, slots, cfg, device="cpu")
        jfn, fn = jax_kvquant.quant_decode_attention, kvquant.quant_decode_attention
    else:
        jcache = jax_attention.init_cache(b, slots, jcfg)
        cache = attention.init_cache(b, slots, cfg, device="cpu")
        jfn, fn = jax_attention.decode_attention, attention.decode_attention
    done = 0
    for s_new in (1, 2, 1, 1, 2, 1, 1, 1, 2, 1, 1, 2, 1, 1, 2):
        x = jnp.asarray(rng.standard_normal((b, s_new, D)), jnp.bfloat16)
        index = start + done
        with jax_kernels.use_policy("backend=pallas"):
            want, jcache = jfn(jparams, x, jcache, jcfg, index=jnp.asarray(index),
                               window=window)
        got, cache = fn(params, t(x), cache, cfg, index=torch.from_numpy(index), window=window)
        close(got, want)
        np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
        done += s_new
    assert done == 20 and int(cache.pos.max()) == 9 + 19
    assert sorted(cache.pos[2].tolist()) == list(range(9 + 20 - slots, 9 + 20))


def test_kv_from_full_ring_layout_matches_jax(attn_pair):
    """A 20-token prefill into an 8-slot window ring keeps positions 12-19,
    each at slot ``position % 8``; a 5-token one pads to 8 with -1."""
    jparams, params, jcfg, cfg = attn_pair
    rng = np.random.default_rng(5)
    for s, window, cache_slots in ((20, 8, 32), (5, 8, 32), (20, None, 24)):
        h = jnp.asarray(rng.standard_normal((2, s, D)), jnp.bfloat16)
        jbd, bd = jax_base.BlockDef(window=window), base.BlockDef(window=window)
        jmodel = dataclasses.replace(jax_config("qwen1.5-0.5b", reduced=True), attn=jcfg)
        with jax_kernels.use_policy("backend=pallas"):
            want = jax_lm._kv_from_full(jparams, h, jmodel, jbd, cache_slots)
        _, (k, v) = attention.attention(params, t(h), cfg, window=window)
        got = lm._kv_from_full(k, v, bd, cache_slots)
        np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
        close(got.k, want.k)
        close(got.v, want.v)
        assert got.k.shape[1] == (min(window, max(cache_slots, s)) if window else cache_slots)


# ---- the dense-ring mask -----------------------------------------------------


@pytest.mark.parametrize("window", [None, 1, 5])
def test_visible_mask_at_its_edges(window):
    """``visible``, the mask of both dense rings, pair by pair against JAX's
    rule: a set key position (-1: an empty slot), not after the query's,
    and with a window, fewer than ``window`` positions before it (the key
    ``window - 1`` back is seen, the one ``window`` back is not)."""
    qp = torch.arange(0, 12)[:, None]
    kp = torch.arange(-1, 12)[None, :]
    got = attention.visible(qp, kp, window)
    want = [[k >= 0 and k <= q and (window is None or q - k < window)
             for k in range(-1, 12)] for q in range(12)]
    np.testing.assert_array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "recurrentgemma-2b-w16", "mamba2-780m"])
def test_page_pools_refuse_recurrent_and_window_archs_as_jax_does(arch):
    """``init_paged_cache`` raises JAX's ``ValueError`` (naming the first
    block that is not global attention), and the dense caches hold a ring
    of min(window, cache_len) slots per local layer and a zero state per
    recurrent one."""
    name = arch.removesuffix("-w16")
    cfg, jcfg = get_config(name, reduced=True), jax_config(name, reduced=True)
    if arch.endswith("-w16"):
        cfg, jcfg = window16_config(cfg), window16_config(jcfg)
    with pytest.raises(ValueError) as want:
        jax_lm.init_paged_cache(jcfg, 8, 8)
    with pytest.raises(ValueError) as got:
        lm.init_paged_cache(cfg, 8, 8, device="cpu")
    assert str(got.value) == str(want.value)
    jcaches = jax_lm.init_cache(jcfg, 2, 64)
    caches = lm.init_cache(cfg, 2, 64, device="cpu")
    flat = [jax.tree.map(lambda a: a[r], jcaches[f"stage{si}"][f"b{j}"])
            for si, (pattern, repeats) in enumerate(jcfg.stages)
            for r in range(repeats) for j in range(len(pattern))]
    for c, w in zip(caches, flat, strict=True):
        assert type(c).__name__ == type(w).__name__
        for got_leaf, want_leaf in zip(c, w, strict=True):
            assert tuple(got_leaf.shape) == tuple(want_leaf.shape)
            np.testing.assert_array_equal(got_leaf.float().numpy(),
                                          np.asarray(want_leaf, np.float32))


def test_server_prefills_window_and_recurrent_archs_unbucketed():
    """The JAX launcher's bucketing rule: a local window or a recurrent
    mixer turns padding off (a pad would enter the ring or the state)."""
    jparams = jax_lm.init(jax_config("recurrentgemma-2b", reduced=True), jax.random.PRNGKey(SEED))
    params = from_jax_params(jax.device_get(jparams), device="cpu")
    cfg = get_config("recurrentgemma-2b", reduced=True)
    for c in (cfg, window16_config(cfg)):
        server = launcher.Server(c, params, device="cpu")
        assert server._bucket is None
        slots = {bd.window: cache.k.shape[1] for bd, cache in zip(c.layer_defs, server.caches)
                 if bd.mixer == "attn"}
        assert slots == {bd.window: min(bd.window, 256) for bd in c.layer_defs
                         if bd.mixer == "attn"}
