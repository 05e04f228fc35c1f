"""K8's tensor-core arithmetic, emulated in plain PyTorch, against the JAX
package's ``flash_attention_bwd_dkv`` (Pallas, interpret mode, 32 x 32
blocks) under the allowance ``chip_smoke.py`` holds K8 to on the card:
``2e-2 x (|want| + the RMS of want's row)``.

The bf16 K8 (``csrc/flash_attention_bwd_dkv.cu``, wgmma design) computes
Sᵀ = K Qᵀ and dPᵀ = V dOᵀ on the tensor cores from bf16 operands (exact
in fp32 up to the order of the sums), P and dS in fp32 as JAX's
``_flash_bwd_dkv_body`` does, then dV += Pᵀ dO and dK += dSᵀ Q as bf16
products: P and dS are rounded to bf16 first.  Those roundings are where
K8 departs from the JAX kernel, whose two products take fp32 P and dS.
A product may instead take its fp32 operand as a hi/lo pair of bf16s
(``x = hi + lo``, two wgmmas), which leaves an error of about 2^-16
relative; :func:`dkv_tensor_core` emulates either form per product.

A key whose every contribution comes from rows that see only that key
gets dK from dS = dP - delta alone: two fp32 sums of the same exact
products, zero in exact arithmetic.  Such keys are held to the bound of
that rounding (two sums of d terms, each within d 2^-24 of the sum of
the terms' magnitudes), as K7's single-key rows are.

The cases cover MHA, GQA and MQA, causal on and off, a window, a
softcap, head dims 16 to 256, sq != sk both ways, rows that see no key,
and a window of one key (every row sees one key).

Run as a script, it emulates K8 at the card's two full-width cells
(qwen1.5-0.5b and gemma2-9b's local layer, as ``chip_smoke.FLASH_SHAPES``
draws them) against the plain version and prints each product's worst
err / allowance with and without the hi/lo split:

    PYTHONPATH=src python tests/test_torch_flash_dkv_rounding.py [--heads N]
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.flash_attention.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.flash_attention import flash_attention_bwd_dkv as jax_dkv
from repro_torch.kernels.flash_attention.flash_attention import (
    _bwd_scores,
    _kv_heads,
    _mask,
    flash_attention_bwd_dkv_plain,
    flash_attention_plain,
)

TOL = 2e-2  # chip_smoke.TOL_BF16, in the row-RMS form of check_flash_close
BLOCK = 32
# The hi/lo split each product takes in the kernel (csrc/flash_attention_bwd_dkv.cu,
# to_frag_split): both.  Each product alone passes 0.6 nowhere here, but
# with P rounded once the path's dV at gemma2-9b's local layer read 1.17 on
# an H100 (K6's lse and the rounding of P add up there).
KERNEL_SPLIT = dict(split_ds=True, split_p=True)

# (b, h, kvh, sq, sk, d, causal, window, softcap)
CASES = [
    (1, 4, 4, 64, 64, 64, True, None, None),
    (1, 4, 2, 96, 96, 32, False, 24, None),
    (1, 4, 1, 96, 96, 64, True, 24, 8.0),
    (2, 4, 2, 64, 96, 16, True, None, 8.0),
    (1, 4, 2, 96, 32, 16, True, 24, None),  # rows 55.. see no key
    (2, 2, 1, 96, 64, 128, False, None, None),
    (1, 2, 1, 64, 64, 256, True, 40, 50.0),
    (1, 2, 2, 64, 64, 32, True, 1, None),  # every row sees one key
]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _product(a, b, split):
    """aᵀ b in fp32 with a rounded to bf16 once, or taken as hi + lo."""
    hi = _bf16(a)
    out = hi.transpose(-1, -2) @ b
    if split:
        out = out + _bf16(a - hi).transpose(-1, -2) @ b
    return out


def dkv_tensor_core(q, k, v, do, lse, delta, *, causal, window, softcap, split_ds, split_p):
    """dK and dV per query head as the bf16 K8 computes them: P and dS in
    fp32, each rounded to bf16 (or split hi/lo) before its product, which
    sums in fp32; each output rounded to the input dtype once."""
    b, h, sq, d = q.shape
    sk, group = k.shape[2], h // k.shape[1]
    kc, vc = _kv_heads(k, 0, h, group), _kv_heads(v, 0, h, group)
    p, ds = _bwd_scores(q, kc, vc, do, lse, delta, _mask(sq, sk, causal, window, q.device),
                        1.0 / math.sqrt(d), softcap)
    dk = _product(ds, q.float(), split_ds).to(k.dtype)
    dv = _product(p, do.float(), split_p).to(v.dtype)
    return dk, dv


def err_over_allowance(got, want):
    g, w = got.float(), want.float()
    allow = TOL * (w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt())
    diff = (g - w).abs()
    if not diff.numel():
        return 0.0
    return float(torch.where(diff > 0, diff / allow, torch.zeros_like(diff)).max())


def single_key_keys(mask):
    """Keys every one of whose viewing rows sees that key alone."""
    one = mask.sum(dim=-1) == 1
    return mask.any(dim=0) & ~(mask & ~one[:, None]).any(dim=0)


def dk_rounding_bound(q, k, v, do, mask):
    """Per (b, h, key) bound on |dK| of the keys of :func:`single_key_keys`:
    the sum over their rows of 2 d 2^-24 sum|dO v| |q| / sqrt(d)."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    one = mask.sum(dim=-1) == 1
    vc = _kv_heads(v, 0, h, group).float()
    keys = single_key_keys(mask)
    hit = mask & one[:, None] & keys[None, :]            # (sq, sk)
    terms = do.float().abs() @ vc.abs().transpose(-1, -2)  # (b, h, sq, sk)
    per = 2 * d * 2.0**-24 * terms * hit / math.sqrt(d) * 1.01
    return (per.transpose(-1, -2) @ q.float().abs())[:, :, keys]


def _jax_case(case):
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    rng = np.random.default_rng(sq * 7 + sk * 3 + d + h * kvh + (window or 0))
    mk = lambda *shape: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)  # noqa: E731
    q, k, v, do = mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d), mk(b, h, sq, d)
    kw = dict(causal=causal, window=window, softcap=softcap, bq=BLOCK, bk=BLOCK,
              interpret=True)
    o, lse = jax_flash(q, k, v, return_lse=True, **kw)
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    dk, dv = jax_dkv(q, k, v, do, lse, delta, **kw)
    return {name: t(np.asarray(x)) for name, x in dict(
        q=q, k=k, v=v, do=do, lse=lse, delta=delta, dk=dk, dv=dv).items()}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_tensor_core_dkv_meets_the_card_allowance(case):
    """The emulated K8, with the kernel's split, passes the card's check
    against JAX's kernel with the margin the design was sized for
    (err / allowance <= 0.6); keys fed only by single-key rows stay within
    the rounding of dP - delta on both sides."""
    x = _jax_case(case)
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    dk, dv = dkv_tensor_core(x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"],
                             causal=causal, window=window, softcap=softcap, **KERNEL_SPLIT)
    for got, want in ((dk, x["dk"]), (dv, x["dv"])):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape == (b, h, sk, d)
        assert torch.isfinite(got.float()).all()
    assert err_over_allowance(dv, x["dv"]) <= 0.6

    mask = _mask(sq, sk, causal, window, "cpu")
    keys = single_key_keys(mask)
    assert err_over_allowance(dk[:, :, ~keys], x["dk"][:, :, ~keys]) <= 0.6
    bound = dk_rounding_bound(x["q"], x["k"], x["v"], x["do"], mask)
    for got in (dk, x["dk"]):
        assert (got[:, :, keys].float().abs() <= bound).all()


def test_a_window_of_one_key_makes_every_key_single():
    """The dK rounding rule has cells to hold: with window 1 every row sees
    its own key alone, and no key is fed by any other row."""
    mask = _mask(64, 64, True, 1, "cpu")
    assert single_key_keys(mask).all()
    assert not single_key_keys(_mask(2048, 2048, True, None, "cpu")).any()
    assert not single_key_keys(_mask(200, 77, True, 16, "cpu")).any()


def _full_width(label, b, h, kvh, s, d, window, softcap, heads, seed):
    """K8 emulated at one full-width cell (the first ``heads`` query heads
    and their kv heads, one at a time) against the plain version, with
    and without the hi/lo split of each product; the allowance is per
    row, so the worst ratio over heads is the cell's."""
    rng = np.random.default_rng(seed)
    group = h // kvh
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, dtype=np.float32)).to(torch.bfloat16)
    q, do = mk(b, heads, s, d), mk(b, heads, s, d)
    k, v = mk(b, -(-heads // group), s, d), mk(b, -(-heads // group), s, d)
    kw = dict(causal=True, window=window, softcap=softcap)
    splits = ((False, False), (True, False), (True, True))
    worst = {sp: [0.0, 0.0] for sp in splits}
    for h0 in range(heads):
        x = dict(q=q[:, h0:h0 + 1], k=k[:, h0 // group:h0 // group + 1],
                 v=v[:, h0 // group:h0 // group + 1], do=do[:, h0:h0 + 1])
        o, lse = flash_attention_plain(x["q"], x["k"], x["v"], return_lse=True, **kw)
        delta = (x["do"].float() * o.float()).sum(-1)
        args = (x["q"], x["k"], x["v"], x["do"], lse, delta)
        want = flash_attention_bwd_dkv_plain(*args, **kw)
        for sp in splits:
            got = dkv_tensor_core(*args, split_ds=sp[0], split_p=sp[1], **kw)
            for i in range(2):
                worst[sp][i] = max(worst[sp][i], err_over_allowance(got[i], want[i]))
    return [dict(cell=label, heads=heads, split_ds=sp[0], split_p=sp[1], dk=w[0], dv=w[1])
            for sp, w in worst.items()]


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=4, help="query heads of gemma2's cell")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for row in (_full_width("qwen1.5-0.5b", 2, 16, 16, 2048, 64, None, None, 16, 0)
                + _full_width("gemma2-9b local layer", 1, 16, 8, 8192, 256, 4096, 50.0,
                              args.heads, 1)):
        print(json.dumps(row), flush=True)
