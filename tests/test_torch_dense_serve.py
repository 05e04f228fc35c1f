"""The port's dense ``Server`` (``--kv dense``) against the JAX launcher.

* ``python -m repro_torch.launch.serve --kv dense --kernel-policy P``
  prints the same ``req …`` lines as ``python -m repro.launch.serve``
  with the same flags on the same (converted) weights, for P in
  ``backend=pallas``, ``mcast`` and ``unicast``.  The flat schedules
  round the product before the epilogue, so their streams differ from
  ``backend=pallas`` ones: each policy is held to its own reference.
* The dense-vs-paged diff: under ``backend=pallas`` the JAX package's
  own dense and paged streams are not identical (dense attention rounds
  its scores to bf16, the paged kernels do not), so the port is held to
  the same diff, line for line, and not to identity.
* Each policy reaches its own kernel wrapper; on the CPU the wrappers run
  the plain versions and the launch counters stay 0 (the card test in
  ``test_torch_cuda.py`` reads them).
* ``decode_attention`` on a ragged batch against the JAX function.

The launcher references run in a child process with XLA's excess
precision off (``_torch_jax_ref.py``); greedy streams must be
token-identical.  Array comparisons state their tolerance (``TOL`` in
``_torch_util.py``)."""
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

from _torch_jax_ref import DENSE_POLICIES, LAUNCH_ARGS, SEED, dense_runs, params_checksum
from _torch_util import close, jax_reference, t
from repro import kernels as jax_kernels
from repro.configs import get_config as jax_config
from repro.models import lm as jax_lm
from repro.nn import attention as jax_attention
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.configs.base import BlockDef
from repro_torch.kernels import api
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.nn import attention
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


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    jparams = jax_lm.init(jax_config("qwen1.5-0.5b", reduced=True), jax.random.PRNGKey(SEED))
    return cfg, jparams, from_jax_params(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory, model):
    out = jax_reference("dense", tmp_path_factory.mktemp("jax_dense"))
    assert float(out["params_checksum"]) == params_checksum(model[1])
    return json.loads(str(out["dense_json"]))


def _port_stdout(params, args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        launcher.main([*args, "--device", "cpu"], params=params)
    return buf.getvalue()


def _req_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("req ")]


@pytest.mark.parametrize("policy", DENSE_POLICIES)
def test_dense_server_matches_jax_launcher(model, ref, policy):
    got = _port_stdout(model[2], dense_runs()[f"dense {policy}"])
    want = ref[f"dense {policy}"]
    assert len(_req_lines(want)) == 6
    assert got == want


def test_dense_is_the_default_backend_and_policy(model, ref):
    """No ``--kv`` and no ``--kernel-policy``: the dense server under the
    cost model's picks, which is JAX's ``backend=pallas`` stream.  As in
    JAX's launcher, ``--kv`` parses to None and ``main`` resolves it:
    dense, or paged under ``--server``."""
    assert launcher.parser().parse_args([]).kv is None
    assert _port_stdout(model[2], LAUNCH_ARGS) == ref["dense backend=pallas"]


def test_flat_policies_change_the_stream(ref):
    """The reference streams themselves: mcast and unicast run the same
    unfused epilogue and agree; ``backend=pallas`` (K1, fused) differs."""
    assert ref["dense mcast"] == ref["dense unicast"]
    assert ref["dense mcast"] != ref["dense backend=pallas"]


@pytest.mark.parametrize("workload", ["shared-prefix", "cold"])
def test_dense_paged_diff_matches_jax(model, ref, workload):
    """The diff the JAX CI runs (``--kv dense`` against ``--kv paged``),
    made in both packages under ``backend=pallas``: the port's two
    streams are the JAX package's two streams, so its diff is JAX's."""
    names = (("dense backend=pallas", "paged backend=pallas") if workload == "shared-prefix"
             else ("cold dense", "cold paged"))
    runs = dense_runs()
    got = [_req_lines(_port_stdout(model[2], runs[n])) for n in names]
    want = [_req_lines(ref[n]) for n in names]
    assert got == want
    assert [a == b for a, b in zip(*got)] == [a == b for a, b in zip(*want)]


@pytest.mark.parametrize("policy,wrapper", [
    ("mcast", "matmul_mcast"), ("unicast", "matmul_unicast"),
    ("tiled", "matmul_tiled"), ("backend=pallas", "matmul_tiled")])
def test_each_policy_runs_its_own_kernel(model, policy, wrapper):
    """Every projection of the dense server goes through the policy's
    wrapper and no other; on the CPU no launch counter moves."""
    _, _, params = model
    names = ("matmul_tiled", "matmul_mcast", "matmul_unicast")
    spies = {n: mock.MagicMock(wraps=getattr(api, n)) for n in names}
    kernels.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        for n, spy in spies.items():
            stack.enter_context(mock.patch.object(api, n, spy))
        _port_stdout(params, [*LAUNCH_ARGS, "--requests", "2", "--max-new", "3",
                              "--kernel-policy", policy])
    calls = {n: spy.call_count for n, spy in spies.items()}
    assert calls[wrapper] > 0 and sum(calls.values()) == calls[wrapper], calls
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_decode_attention_matches_jax_on_a_ragged_batch(model):
    """One decode token per slot at its own position, into a ring that
    holds a masked (-1) tail, a hole and an empty slot row."""
    cfg, jparams, params = model
    rng = np.random.default_rng(11)
    b, slots = 3, 12
    kv, hd = cfg.attn.n_kv_heads, cfg.attn.head_dim
    k0 = rng.standard_normal((b, slots, kv, hd)).astype(np.float32)
    v0 = rng.standard_normal((b, slots, kv, hd)).astype(np.float32)
    pos = np.full((b, slots), -1, np.int32)
    pos[0, :7] = np.arange(7)
    pos[1, :4] = np.arange(4)
    pos[1, 2] = -1  # a masked bucket-padding row
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    index = np.array([7, 4, 0], np.int32)
    jcache = jax_attention.KvCache(k=jnp.asarray(k0, jnp.bfloat16),
                                   v=jnp.asarray(v0, jnp.bfloat16), pos=jnp.asarray(pos))
    jp = jax.tree.map(lambda a: a[0], jparams["stage0"]["b0"]["attn"])
    with jax_kernels.use_policy("backend=pallas"):
        want, wcache = jax_attention.decode_attention(
            jp, jnp.asarray(x, jnp.bfloat16), jcache, jax_config(
                "qwen1.5-0.5b", reduced=True).attn, index=jnp.asarray(index))
    cache = attention.KvCache(k=t(jcache.k), v=t(jcache.v), pos=torch.from_numpy(pos.copy()))
    got, cache = attention.decode_attention(params["layers"][0]["attn"], t(x).to(torch.bfloat16),
                                            cache, cfg.attn, index=torch.from_numpy(index))
    close(got, want)
    assert torch.equal(cache.pos, torch.from_numpy(np.array(wcache.pos)))
    close(cache.k, wcache.k)


def test_mask_cache_after_marks_the_padded_tail(model):
    cfg, _, params = model
    toks = torch.arange(1, 17)[None]
    _, caches = lm.prefill(params, cfg, toks, cache_slots=24)
    masked = lm.mask_cache_after(caches, 11)
    for c, m in zip(caches, masked):
        assert m.pos.tolist()[0] == list(range(11)) + [-1] * 13
        assert torch.equal(m.k, c.k)


def test_unported_dense_cache_options_raise(model):
    """int8 rings are ported (``QuantKvCache`` leaves, ROADMAP Queue 1
    item 1), and local-window rings (min(window, cache_len) slots); a
    post-block norm adds no cache."""
    from repro_torch.nn.kvquant import QuantKvCache

    cfg = model[0]
    caches = lm.init_cache(cfg, 2, 16, kv_dtype="int8", device="cpu")
    assert len(caches) == cfg.n_layers
    kv, hd = cfg.attn.n_kv_heads, cfg.attn.head_dim
    for c in caches:
        assert isinstance(c, QuantKvCache)
        assert c.k.dtype == c.v.dtype == torch.int8 and c.k.shape == (2, 16, kv, hd)
        assert c.k_scale.dtype == torch.bfloat16 and c.k_scale.shape == (2, 16, kv, 1)
        assert c.pos.tolist() == [[-1] * 16] * 2
    windowed = dataclasses.replace(cfg, stages=(((BlockDef(window=8),), cfg.n_layers),))
    assert [c.k.shape[1] for c in lm.init_cache(windowed, 2, 16, device="cpu")] == \
        [8] * cfg.n_layers
    # post-block norms have no caches of their own (tests/test_torch_families.py)
    assert len(lm.init_cache(dataclasses.replace(cfg, post_block_norm=True), 2, 16,
                             device="cpu")) == cfg.n_layers
