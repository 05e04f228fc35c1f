"""The port's flash-attention family — K6 ``flash_attention`` (O and
lse), K7 ``flash_attention_bwd_dq`` and K8 ``flash_attention_bwd_dkv`` —
against the JAX package's Pallas kernels run in interpret mode, and the
port's ``attention_ref`` against JAX's.  On the CPU the port's wrappers
run their plain versions.

The same numpy-seeded ``q, k, v, do`` go to both sides, and the
backward kernels of both get the same ``lse`` (JAX's forward) and
``delta = rowsum(do * o)``.  JAX runs with explicit 32 x 32 blocks, so
its online softmax takes several steps per row.  Stated tolerances:

* fp32: 1e-5 forward (O, lse) and 1e-4 for the gradients — the two sides
  sum in other orders (blockwise vs whole rows);
* bf16: 2e-2 absolute and relative, about two bf16 ulps — the forward
  rounds p to bf16 relative to the running max in JAX's blocks and to
  the row max in the plain version, and each output is rounded once.

The cases cover MHA, GQA and MQA, causal on and off, a window, a
softcap, s 64 and 96, sq != sk both ways, and rows that see no key
(sq > sk + window - 1: the mean of V, lse = NEG_INF, and p = 1 in the
backward)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.flash_attention.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.flash_attention import flash_attention_bwd_dkv as jax_dkv
from repro.kernels.flash_attention.flash_attention import flash_attention_bwd_dq as jax_dq
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import (
    NEG_INF,
    attention_ref,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL_FWD = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
TOL_GRAD = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
D = 16

# (b, h, kvh, sq, sk, causal, window, softcap, dtype, block)
CASES = [
    (1, h, kvh, s, s, causal, window, softcap, dtype, 32)
    for h, kvh in ((4, 4), (4, 2), (4, 1))
    for dtype in (torch.float32, torch.bfloat16)
    for causal, window, softcap, s in ((True, None, None, 64), (False, 24, None, 96),
                                       (True, 24, 8.0, 96), (False, None, 8.0, 64))
] + [
    (2, 4, 2, 64, 96, True, None, 8.0, dtype, 32) for dtype in (torch.float32, torch.bfloat16)
] + [
    (2, 4, 1, 96, 64, False, 24, None, dtype, 32) for dtype in (torch.float32, torch.bfloat16)
] + [
    # rows 55.. see no key: sq > sk + window - 1
    (1, 4, 2, 96, 32, True, 24, None, dtype, 32) for dtype in (torch.float32, torch.bfloat16)
] + [
    (1, 1, 1, 8, 2, True, 2, None, torch.float32, 128),  # rows 3..7 see no key
]


@pytest.fixture(autouse=True)
def _one_thread():
    """The suite runs in several workers: torch on one thread each, as in
    the other files of the port's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _id(case):
    b, h, kvh, sq, sk, causal, window, softcap, dtype, _ = case
    return (f"b{b}-h{h}kv{kvh}-sq{sq}sk{sk}-{'causal' if causal else 'full'}-w{window}"
            f"-cap{softcap}-{str(dtype).removeprefix('torch.')}")


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """Inputs and the JAX kernels' outputs (numpy), once per case."""
    b, h, kvh, sq, sk, causal, window, softcap, dtype, block = case
    d = 4 if sq == 8 else D
    rng = np.random.default_rng(sq * 1000 + sk * 10 + h + kvh)
    mk = lambda *shape: jnp.asarray(rng.standard_normal(shape), JNP[dtype])  # noqa: E731
    q, k, v, do = mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d), mk(b, h, sq, d)
    kw = dict(causal=causal, window=window, softcap=softcap, bq=block, bk=block,
              interpret=True)
    o, lse = jax_flash(q, k, v, return_lse=True, **kw)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    dq = jax_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = jax_dkv(q, k, v, do, lse, delta, **kw)
    return {name: np.asarray(x) for name, x in dict(
        q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv).items()}


def _torch_inputs(case):
    arrays = _jax_run(case)
    return {name: t(arrays[name]) for name in ("q", "k", "v", "do", "lse", "delta")}, arrays


def _opts(case):
    _, _, _, _, _, causal, window, softcap, _, _ = case
    return dict(causal=causal, window=window, softcap=softcap)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_matches_jax_kernel(case):
    x, want = _torch_inputs(case)
    o, lse = flash_attention(x["q"], x["k"], x["v"], return_lse=True, **_opts(case))
    dtype = case[8]
    assert o.dtype == dtype and lse.dtype == torch.float32
    _close(o, want["o"], TOL_FWD[dtype])
    _close(lse, want["lse"], dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_bwd_dq_matches_jax_kernel(case):
    x, want = _torch_inputs(case)
    dq = flash_attention_bwd_dq(x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                                **_opts(case))
    assert dq.dtype == case[8] and dq.shape == x["q"].shape
    _close(dq, want["dq"], TOL_GRAD[case[8]])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_bwd_dkv_matches_jax_kernel(case):
    """dK and dV per query head, (b, h, sk, d), as JAX's kernel returns them."""
    x, want = _torch_inputs(case)
    dk, dv = flash_attention_bwd_dkv(x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                                     **_opts(case))
    b, h, _, d = x["q"].shape
    assert dk.shape == dv.shape == (b, h, x["k"].shape[2], d)
    _close(dk, want["dk"], TOL_GRAD[case[8]])
    _close(dv, want["dv"], TOL_GRAD[case[8]])


def test_rows_that_see_no_key_average_v():
    """The JAX kernel's answer for a row with every score masked: p = 1
    for every key, so O is the mean of V and lse rounds to NEG_INF."""
    case = CASES[-1]
    x, want = _torch_inputs(case)
    o, lse = flash_attention(x["q"], x["k"], x["v"], return_lse=True, **_opts(case))
    mean_v = x["v"].mean(dim=2)[0, 0]
    torch.testing.assert_close(o[0, 0, 3:], mean_v.expand(5, -1), rtol=1e-6, atol=1e-6)
    assert (lse[0, 0, 3:] == NEG_INF).all() and (want["lse"][0, 0, 3:] == NEG_INF).all()


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == 2 or c[3] == 8], ids=_id)
def test_attention_ref_matches_jax(case):
    x, arrays = _torch_inputs(case)
    want = jax_attention_ref(jnp.asarray(arrays["q"]), jnp.asarray(arrays["k"]),
                             jnp.asarray(arrays["v"]), **_opts(case))
    got = attention_ref(x["q"], x["k"], x["v"], **_opts(case))
    _close(got, want, TOL_FWD[case[8]])


def test_checks_raise_like_the_jax_asserts():
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="need q"):
        flash_attention(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    lse = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd_dq(q, q, q, q, lse[..., :4], lse)
