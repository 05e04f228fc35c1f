"""K7's tensor-core arithmetic, emulated in plain PyTorch, against the JAX
package's ``flash_attention_bwd_dq`` (Pallas, interpret mode, 32 x 32
blocks) under the allowance ``chip_smoke.py`` holds K7 to on the card:
``2e-2 x (|want| + the RMS of want's row)``.

The bf16 K7 (``csrc/flash_attention_bwd_dq.cu``, wgmma design) computes
S = Q Kᵀ and dP = dO Vᵀ on the tensor cores from bf16 operands, which is
exact in fp32 up to the order of the sums; dS in fp32 as JAX's
``_flash_bwd_dq_body`` does; then dQ += dS K as a bf16 product, so dS is
rounded to bf16 first.  That rounding is the one place where K7 departs
from the JAX kernel's fp32 arithmetic.  The emulation here is that
arithmetic: the plain version's dS, rounded to bf16, times K in fp32,
dQ rounded once.  The inputs, numpy-seeded, are the same on both sides,
and both get JAX's lse and ``delta = rowsum(do * o)``.

A row that sees exactly one key is apart: there p = 1 and dS = dP - delta,
the difference of two fp32 sums of the same d exact products, so dQ is 0
in exact arithmetic and every implementation returns its own rounding of
it.  The row-RMS allowance has no width there (JAX's row may be exactly
0), so those rows are held instead to the bound of that rounding: two
fp32 sums of d terms each err by at most d 2^-24 times the sum of the
terms' magnitudes, as ``chip_smoke.check_flash_close`` holds them on the
card.

The cases cover MHA, GQA and MQA, causal on and off, a window, a softcap,
head dims 16 to 128, sq != sk both ways, and rows that see no key."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.flash_attention.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.flash_attention import flash_attention_bwd_dq as jax_dq
from repro_torch.kernels.flash_attention.flash_attention import _bwd_scores, _kv_heads, _mask


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-2  # chip_smoke.TOL_BF16, in the row-RMS form of check_flash_close
BLOCK = 32

# (b, h, kvh, sq, sk, d, causal, window, softcap)
CASES = [
    (1, 4, 4, 64, 64, 64, True, None, None),
    (1, 4, 2, 96, 96, 32, False, 24, None),
    (1, 4, 1, 96, 96, 64, True, 24, 8.0),
    (2, 4, 2, 64, 96, 16, True, None, 8.0),
    (1, 4, 2, 96, 32, 16, True, 24, None),  # rows 55.. see no key
    (2, 2, 1, 96, 64, 128, False, None, None),
]


def _jax_case(case):
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    rng = np.random.default_rng(sq * 7 + sk * 3 + d + h * kvh)
    mk = lambda *shape: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)  # noqa: E731
    q, k, v, do = mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d), mk(b, h, sq, d)
    kw = dict(causal=causal, window=window, softcap=softcap, bq=BLOCK, bk=BLOCK,
              interpret=True)
    o, lse = jax_flash(q, k, v, return_lse=True, **kw)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    dq = jax_dq(q, k, v, do, lse, delta, **kw)
    return {name: t(np.asarray(x)) for name, x in dict(
        q=q, k=k, v=v, do=do, lse=lse, delta=delta, dq=dq).items()}


def dq_tensor_core(q, k, v, do, lse, delta, *, causal, window, softcap):
    """dQ as the bf16 K7 computes it: dS in fp32, rounded to bf16 before
    the dS K product, which sums in fp32; dQ rounded to q's dtype once."""
    b, h, sq, d = q.shape
    sk, group = k.shape[2], h // k.shape[1]
    kc, vc = _kv_heads(k, 0, h, group), _kv_heads(v, 0, h, group)
    _, ds = _bwd_scores(q, kc, vc, do, lse, delta, _mask(sq, sk, causal, window, q.device),
                        1.0 / math.sqrt(d), softcap)
    return (ds.to(torch.bfloat16).float() @ kc.float()).to(q.dtype)


def _err_over_allowance(got, want):
    g, w = got.float(), want.float()
    allow = TOL * (w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt())
    diff = (g - w).abs()
    return float(torch.where(diff > 0, diff / allow, torch.zeros_like(diff)).max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tensor_core_dq_meets_the_card_allowance(case):
    """The emulated K7 passes the card's check against JAX's kernel with
    the margin the design was sized for (err / allowance <= 0.6), and on
    rows that see one key both stay within the rounding of dP - delta."""
    x = _jax_case(case)
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    got = dq_tensor_core(x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                         causal=causal, window=window, softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.shape == x["dq"].shape
    assert torch.isfinite(got.float()).all()

    mask = _mask(sq, sk, causal, window, "cpu")
    one = mask.sum(dim=-1) == 1  # rows that see exactly one key
    rest = ~one
    assert _err_over_allowance(got[:, :, rest], x["dq"][:, :, rest]) <= 0.6

    key = mask.float().argmax(dim=-1)[one]
    kc = _kv_heads(x["k"], 0, h, h // kvh).float()[:, :, key]
    vc = _kv_heads(x["v"], 0, h, h // kvh).float()[:, :, key]
    terms = (x["do"].float()[:, :, one].abs() * vc.abs()).sum(dim=-1, keepdim=True)
    bound = 2 * d * 2.0**-24 * terms * kc.abs() / math.sqrt(d) * 1.01
    for dq in (got, x["dq"]):
        assert (dq[:, :, one].float().abs() <= bound).all()
