"""The arithmetic of K9's and K10's ``chunk-parallel`` design, emulated in
plain PyTorch, against the JAX package's Pallas kernels (interpret mode)
under the tolerance ``chip_smoke`` holds K9 and K10 to on the card,
``TOL_SCAN``: |got - want| <= 1e-4 x (|want| + the RMS of want's row),
the row being the last axis (P, N) and the sequence for d log a.  Both
sides compute in fp32 and sum in other orders; 1e-4 leaves room for that
and for products that are fp32-accurate but not fp32: the kernels run
every product on the tensor cores in 3xTF32, each operand split into a
TF32 big part (``cvt.rna.tf32.f32``: to nearest, ties away from zero) and
a TF32 remainder, summing small.big + big.small + big.big.  One TF32 pass
(big.big alone) keeps about three decimal digits, and the last case shows
that this check sees it.

The emulation follows the kernels (``csrc/ssd_scan_fwd.cu``,
``csrc/ssd_scan_bwd.cu``) pass by pass, on the chunk ``SSD_CHUNK`` = 64:
K9 computes the scores S = C B^T once per (batch, chunk) for all heads —
on the fp64 tensor cores, exact products and fp64 sums rounded once to
fp32, since where C_i . B_j cancels an fp32-accurate sum is not enough —
each chunk's contribution F_c = (xdt o v)^T B, then the states in order
over the chunks (H_0 = 0, H_c+1 = fma(exp(l_Q), H_c, F_c)), then each
chunk's y = exp(l) o (C H_c^T) + (decay o S) xdt.  K10 computes S and
E_c = (dy o w)^T C, the adjoint states in reverse (G_nc-1 = 0), then per
chunk T = dy xdt^T, dxdt, dC and dB (the w- and v-scaled terms first)
and the four terms of d log a.  The JAX kernels carry the state through
one chunk grid in order; where their chunk differs from 64 (their chunk
must divide s) the function, not the chunking, is compared.

Cases: the ``CASES`` of ``test_torch_ssd.py`` (s = 200 with a short last
chunk of 8 steps), one chunk (s = 40), and an N of several N tiles
(160: 5 of K10's 32-column tiles, 3 of K9's 64)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.api import _ssd_lcum as jax_ssd_lcum
from repro.kernels.ssd.ssd import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ssd import ssd_scan_bwd as jax_ssd_scan_bwd
from repro_torch.kernels.ssd import SSD_CHUNK, ssd_lcum
from test_torch_ssd import CASES, _inputs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_SCAN = 1e-4  # chip_smoke.TOL_SCAN
Q = SSD_CHUNK

# (b, h, s, P, N, the JAX kernel's chunk): CASES without the port's chunk
# column (the kernels' is always 64), then one chunk and N = 160
ROUNDING_CASES = [c[:6] for c in CASES] + [(1, 2, 40, 32, 48, 40), (1, 2, 128, 32, 160, 64)]


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the fp32 bits: keep 10 mantissa bits,
    rounding to nearest with ties away from zero (half a TF32 ulp added to
    the magnitude, the 13 low bits cleared; fp32 is sign-magnitude); inf
    and NaN (exponent all ones) pass through unchanged."""
    bits = x.contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, (bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the kernels' mma.sync on TF32 operands: 3 passes, small.big +
    big.small + big.big; 1 pass, big.big alone.  Products of TF32 values
    are exact in fp32; the sums are fp32."""
    ab, bb = rna_tf32(a), rna_tf32(b)
    if passes == 1:
        return ab @ bb
    return rna_tf32(a - ab) @ bb + ab @ rna_tf32(b - bb) + ab @ bb


def exp(x):
    """expf to within its rounding: exp in fp64, rounded once.  (The CPU's
    vectorised fp32 exp departs from that on some elements, and which ones
    depends on how the tensor is split among threads.)"""
    return torch.exp(x.double()).float()


def scores(cm, bm):
    """S = C B^T as the kernels' fp64 tensor cores give it: exact products,
    fp64 sums, one rounding to fp32 (whatever ``passes`` the rest takes)."""
    return (cm.double() @ bm.double().transpose(-1, -2)).float()


def fma(a, x, y):
    """fmaf elementwise: one rounding of a x + y (exact in fp64 first)."""
    return (a.double() * x.double() + y.double()).float()


def _chunks(xdt, b, c, lcum):
    """fp32 chunk views on Q = 64, the short last chunk padded (identity
    decay, zero input): x (b, h, nc, Q, P), B and C (b, 1, nc, Q, N),
    l (b, h, nc, Q), and the masked decay exp(l_i - l_j) (j <= i)."""
    bsz, h, s, p = xdt.shape
    pad = -(-s // Q) * Q - s
    x = torch.nn.functional.pad(xdt, (0, 0, 0, pad)).reshape(bsz, h, -1, Q, p)
    bm = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(bsz, 1, -1, Q, b.shape[-1])
    cm = torch.nn.functional.pad(c, (0, 0, 0, pad)).reshape(bsz, 1, -1, Q, c.shape[-1])
    l = lcum[..., 0]
    l = torch.cat([l, l[..., -1:].expand(bsz, h, pad)], dim=-1).reshape(bsz, h, -1, Q)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    gap = torch.where(causal, l[..., :, None] - l[..., None, :], 0.0)
    decay = torch.where(causal, exp(gap), 0.0)
    return x, bm, cm, l, decay


def _unchunk(v, s):
    return v.reshape(*v.shape[:2], -1, v.shape[-1])[:, :, :s]


def emulate_ssd_scan(xdt, b, c, lcum, passes=3):
    """K9's chunk-parallel arithmetic: (y (b, h, s, P), states (b, h, nc, P, N))."""
    x, bm, cm, l, decay = _chunks(xdt, b, c, lcum)
    cb = scores(cm, bm)  # (b, 1, nc, Q, Q): once for every head
    ltot = l[..., -1]
    v = exp(ltot[..., None] - l)
    fresh = mm((x * v[..., None]).transpose(-1, -2), bm, passes)  # F_c
    states = torch.empty_like(fresh)
    h = torch.zeros_like(fresh[:, :, 0])
    for ci in range(fresh.shape[2]):
        states[:, :, ci] = h
        h = fma(exp(ltot[:, :, ci])[..., None, None], h, fresh[:, :, ci])
    y = exp(l)[..., None] * mm(cm, states.transpose(-1, -2), passes) \
        + mm(decay * cb, x, passes)
    return _unchunk(y, xdt.shape[2]), states


def emulate_ssd_scan_bwd(xdt, b, c, lcum, states, dy, passes=3):
    """K10's chunk-parallel arithmetic: (dxdt, dB and dC per head, d log a)."""
    s = xdt.shape[2]
    x, bm, cm, l, decay = _chunks(xdt, b, c, lcum)
    dyc = torch.nn.functional.pad(dy, (0, 0, 0, x.shape[2] * Q - s)).reshape(x.shape)
    ltot = l[..., -1]
    w, v = exp(l), exp(ltot[..., None] - l)
    cb = scores(cm, bm)
    fresh = mm((dyc * w[..., None]).transpose(-1, -2), cm, passes)  # E_c
    gs = torch.empty_like(fresh)
    g = torch.zeros_like(fresh[:, :, 0])
    for ci in reversed(range(fresh.shape[2])):
        gs[:, :, ci] = g
        g = fma(exp(ltot[:, :, ci])[..., None, None], g, fresh[:, :, ci])
    m = decay * cb
    tm = mm(dyc, x.transpose(-1, -2), passes)
    dtm = decay * tm
    dx = mm(m.transpose(-1, -2), dyc, passes) + mm(v[..., None] * bm, gs.transpose(-1, -2), passes)
    dyh = w[..., None] * mm(dyc, states, passes)
    xg = v[..., None] * mm(x, gs, passes)
    dc = dyh + mm(dtm, bm, passes)
    db = xg + mm(dtm.transpose(-1, -2), cm, passes)
    # (a): column suffix sums of Z = M o T, summed left of the diagonal
    suffix = (m * tm).flip(-2).cumsum(-2).flip(-2)
    dl = (suffix * torch.ones(Q, Q).tril(-1)).sum(-1)
    u, r = (dyh * cm).sum(-1), (xg * bm).sum(-1)
    dl = dl + u.flip(-1).cumsum(-1).flip(-1)  # (b)
    dl = dl + (r.cumsum(-1) - r)  # (c)
    dl = dl + exp(ltot)[..., None] * (states * gs).sum(dim=(-1, -2))[..., None]  # (d)
    return tuple(_unchunk(v_, s) for v_ in (dx, db, dc, dl[..., None]))


def over_allowance(got, want) -> float:
    """The worst |got - want| / (TOL_SCAN x (|want| + row RMS)), row the last axis."""
    g, w = got.float(), torch.tensor(np.asarray(want, np.float32))
    allow = TOL_SCAN * (w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt())
    diff = (g - w).abs()
    assert bool(torch.isfinite(g).all())
    return float(torch.where(diff > 0, diff / allow, torch.zeros_like(diff)).max())


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX kernels on their own chunk: (y, states, dxdt, dB, dC, d log a)."""
    b, h, s, p, n, jax_chunk = case
    xdt, bm, cm, log_a, dy = _inputs(b, h, s, p, n)
    lc = jax_ssd_lcum(jnp.asarray(log_a), jax_chunk)
    y, states = jax_ssd_scan(jnp.asarray(xdt), jnp.asarray(bm), jnp.asarray(cm), lc,
                             chunk=jax_chunk, return_states=True, interpret=True)
    grads = jax_ssd_scan_bwd(jnp.asarray(xdt), jnp.asarray(bm), jnp.asarray(cm), lc, states,
                             jnp.asarray(dy), chunk=jax_chunk, interpret=True)
    return (np.asarray(y), np.asarray(states), *map(np.asarray, grads))


def _emulated(case, passes):
    b, h, s, p, n, _ = case
    xdt, bm, cm, log_a, dy = map(t, _inputs(b, h, s, p, n))
    lcum = ssd_lcum(log_a, Q)
    y, states = emulate_ssd_scan(xdt, bm, cm, lcum, passes)
    return (y, states, *emulate_ssd_scan_bwd(xdt, bm, cm, lcum, states, dy, passes))


@pytest.mark.parametrize("case", ROUNDING_CASES, ids=str)
def test_chunk_parallel_3xtf32_forward_within_tol_scan(case):
    want = _jax(case)
    y, states = _emulated(case, 3)[:2]
    assert over_allowance(y, want[0]) <= 1
    if case[5] == Q:  # the same checkpoints
        assert over_allowance(states, want[1]) <= 1


@pytest.mark.parametrize("case", ROUNDING_CASES, ids=str)
def test_chunk_parallel_3xtf32_adjoint_within_tol_scan(case):
    want = _jax(case)
    got = _emulated(case, 3)[2:]
    for name, g, w in zip(("dxdt", "dB", "dC"), got[:3], want[2:5]):
        assert over_allowance(g, w) <= 1, name
    assert over_allowance(got[3][..., 0], want[5][..., 0]) <= 1, "d log a"


def test_one_tf32_pass_fails_tol_scan():
    """The same check at the JAX test's widest case sees one TF32 pass:
    every output departs beyond its allowance."""
    case = ROUNDING_CASES[2]
    want = _jax(case)
    got = _emulated(case, 1)
    assert over_allowance(got[0], want[0]) > 1
    for g, w in zip(got[2:5], want[2:5]):
        assert over_allowance(g, w) > 1
    assert over_allowance(got[5][..., 0], want[5][..., 0]) > 1


def test_rna_tf32_rounds_to_nearest_away_and_keeps_inf_and_nan():
    """The emulated rounding against one written from the definition, on
    normal fp32 values of every scale and on ties (1 + 2^-11 rounds away
    from zero); the largest fp32 rounds up to inf; inf stays inf and
    every NaN stays NaN — the card's default 0x7fffffff and 0xffffffff
    among them, which the add alone would carry into the sign and the
    exponent (-0.0 and +0.0)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-120, 120, 4096))).astype(np.float32)
    x = np.concatenate([x, np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 * 2.0 ** -12])])
    m, e = np.frexp(x.astype(np.float64))  # |m| in [0.5, 1): 11 significant bits are m 2^11
    want = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * np.exp2(e - 11.0)
    np.testing.assert_array_equal(rna_tf32(torch.from_numpy(x)).numpy(), want.astype(np.float32))
    assert rna_tf32(torch.tensor([np.finfo(np.float32).max])).item() == float("inf")
    special = torch.tensor([0x7F800000, -0x800000, 0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001],
                           dtype=torch.int32).view(torch.float32)
    got = rna_tf32(special)
    assert got[:2].tolist() == [float("inf"), float("-inf")]
    assert torch.isnan(got[2:]).all()
