"""The arithmetic of K11's and K12's ``chunked-lookback`` design, emulated
in plain PyTorch fp32, against the JAX package's Pallas kernels
(interpret mode) under the tolerance ``chip_smoke`` holds K11 and K12 to
on the card, ``TOL_SCAN``: |got - want| <= 1e-4 x (|want| + the RMS of
want's row), the row being the channels.

The emulation follows the kernels (``csrc/rglru_scan_fwd.cu``,
``csrc/rglru_scan_bwd.cu``, ``csrc/rglru_common.cuh``) on their chunk
``RGLRU_CHUNK`` = 64, the last chunk short: each chunk walks its steps
from a zero carry for its aggregate (A, the product of its decays, in
walk order; L, the carry that leaves it), the carry entering each chunk
is composed from the chunks before it (after it, for K12), and each
chunk walks its steps again from that carry, every step a product then a
sum, as the sequential recurrence.  How the carry is composed depends on
what each tile finds, so the three ends are covered: "walked", every
tile finds its predecessor's prefix out before it walks, walks once from
it and publishes its walk's last state (the sequential recurrence, to
the bit); "prefixes", every tile looks back and finds its nearest
predecessor's inclusive prefix A carry + L; "aggregates", every tile
finds none but the first chunk's (the look-back folds every aggregate,
nearest first: L' = A L_j + L, A' = A A_j, then applies the fold to the
first chunk's prefix).  The JAX kernels carry the state through one
sequential grid, so they are the sequential recurrence's rounding.

Cases: ``test_torch_rglru.py``'s ``SHAPES``, slow decays (log a uniform in
[-0.1, -1e-4]: a carry that survives many chunks), s < 64 (one chunk),
and s = 3 x 64 + 5 (a ragged last chunk).  The last tests show that the
check sees a carry dropped at one chunk start."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro.kernels.rglru.rglru import rglru_scan as jax_rglru_scan
from repro.kernels.rglru.rglru import rglru_scan_bwd as jax_rglru_scan_bwd
from repro_torch.kernels.rglru import RGLRU_CHUNK, rglru_scan_bwd_plain, rglru_scan_plain
from test_torch_rglru import SHAPES, _blocks, _inputs


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
T = RGLRU_CHUNK
ORDERS = ("walked", "prefixes", "aggregates")
# (b, s, d, slow decays)
CASES = [(*shape, False) for shape in SHAPES] + [
    (1, 1024, 128, True), (2, 40, 128, False), (2, 3 * T + 5, 256, False)]


def _case_inputs(b, s, d, slow):
    a, x, dh = _inputs(b, s, d, seed=3)
    if slow:
        rng = np.random.default_rng(4)
        a = np.exp(rng.uniform(-0.1, -1e-4, (b, s, d))).astype(np.float32)
    return a, x, dh


def _chunks(x, fill):
    """(b, s, d) -> (b, nc, T, d), the last chunk padded with ``fill``
    (decay 1, input 0: the pad steps change no state, to the bit)."""
    b, s, d = x.shape
    pad = -(-s // T) * T - s
    x = torch.cat([x, torch.full((b, pad, d), fill, dtype=x.dtype)], dim=1)
    return x.reshape(b, -1, T, d)


def _carries(agg_a, agg_l, first_prefix, walk, order, drop=None):
    """The carry entering each position along the scan (position 0 first),
    (b, n, d), from the aggregates by position, position 0's prefix and
    ``walk(k, carry)``, the last state of position k's walk from carry.
    ``drop``: a position whose carry-in is taken as 0 (a planted fault)."""
    n = agg_a.shape[1]
    carry = [torch.zeros_like(first_prefix)]
    prefix = [first_prefix]
    for k in range(1, n):
        if order != "aggregates":
            c = prefix[k - 1]  # the fold of no aggregate applied to it: 1 P + 0
        else:
            acc_a, acc_l = torch.ones_like(first_prefix), torch.zeros_like(first_prefix)
            for j in range(k - 1, 0, -1):
                acc_l = acc_a * agg_l[:, j] + acc_l
                acc_a = acc_a * agg_a[:, j]
            c = acc_a * prefix[0] + acc_l
        if k == drop:
            c = torch.zeros_like(c)
        carry.append(c)
        prefix.append(walk(k, c) if order == "walked" else agg_a[:, k] * c + agg_l[:, k])
    return torch.stack(carry, dim=1)


def emulate_rglru_scan(a, x, order, drop=None):
    """K11's chunked-lookback arithmetic: h (b, s, d) fp32.  ``drop``: the
    chunk whose carry-in is dropped."""
    s = a.shape[1]
    ac, xc = _chunks(a, 1.0), _chunks(x, 0.0)
    prod, state = torch.ones_like(ac[:, :, 0]), torch.zeros_like(ac[:, :, 0])
    for r in range(T):  # every chunk from a zero state
        prod = ac[:, :, r] * prod
        state = ac[:, :, r] * state + xc[:, :, r]

    def walk(k, state):
        for r in range(T):
            state = ac[:, k, r] * state + xc[:, k, r]
        return state

    # position k is chunk k; chunk 0 walks once from 0, so its prefix is L_0
    carry = _carries(prod, state, state[:, 0], walk, order, drop)
    hs, state = [], carry
    for r in range(T):
        state = ac[:, :, r] * state + xc[:, :, r]
        hs.append(state)
    return torch.stack(hs, dim=2).reshape(a.shape[0], -1, a.shape[2])[:, :s]


def emulate_rglru_scan_bwd(a, h_prev, dh, order, drop=None):
    """K12's chunked-lookback arithmetic: (da, db) fp32.  Positions count
    chunks from the last; ``drop``: the chunk whose carry-in is dropped."""
    s = a.shape[1]
    ac, hc, gc = (_chunks(v, f) for v, f in ((a, 1.0), (h_prev, 0.0), (dh, 0.0)))
    ac, hc, gc = (v.flip(1) for v in (ac, hc, gc))  # by position
    prod, leaving = torch.ones_like(ac[:, :, 0]), torch.zeros_like(ac[:, :, 0])
    for r in reversed(range(T)):
        prod = ac[:, :, r] * prod
        leaving = ac[:, :, r] * (gc[:, :, r] + leaving)

    def walk(k, carry):
        for r in reversed(range(T)):
            carry = ac[:, k, r] * (gc[:, k, r] + carry)
        return carry

    nc = ac.shape[1]
    carry = _carries(prod, leaving, leaving[:, 0], walk, order,
                     None if drop is None else nc - 1 - drop)
    da, db = torch.empty_like(ac), torch.empty_like(ac)
    for r in reversed(range(T)):
        g = gc[:, :, r] + carry
        da[:, :, r], db[:, :, r] = g * hc[:, :, r], g
        carry = ac[:, :, r] * g
    return tuple(v.flip(1).reshape(a.shape[0], -1, a.shape[2])[:, :s] for v in (da, db))


def over_allowance(got, want) -> float:
    """The worst |got - want| / (TOL_SCAN x (|want| + row RMS)), row the last axis."""
    g, w = got.float(), torch.tensor(np.asarray(want, np.float32))
    allow = TOL_SCAN * (w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt())
    diff = (g - w).abs()
    assert bool(torch.isfinite(g).all())
    return float(torch.where(diff > 0, diff / allow, torch.zeros_like(diff)).max())


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX kernels: (h, h_prev, da, db), h_prev from JAX's oracle."""
    b, s, d, slow = case
    a, x, dh = _case_inputs(b, s, d, slow)
    blocks = _blocks(s, d)
    h = jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), **blocks, interpret=True)
    ref = np.asarray(jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(x)))
    h_prev = np.concatenate([np.zeros_like(ref[:, :1]), ref[:, :-1]], axis=1)
    da, db = jax_rglru_scan_bwd(jnp.asarray(a), jnp.asarray(h_prev), jnp.asarray(dh),
                                **blocks, interpret=True)
    return np.asarray(h), h_prev, np.asarray(da), np.asarray(db)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_lookback_forward_within_tol_scan(case, order):
    a, x, _ = _case_inputs(*case)
    assert over_allowance(emulate_rglru_scan(t(a), t(x), order), _jax(case)[0]) <= 1


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_lookback_adjoint_within_tol_scan(case, order):
    a, _, dh = _case_inputs(*case)
    _, h_prev, want_da, want_db = _jax(case)
    da, db = emulate_rglru_scan_bwd(t(a), t(h_prev), t(dh), order)
    assert over_allowance(da, want_da) <= 1
    assert over_allowance(db, want_db) <= 1


def test_the_walked_order_is_the_sequential_recurrence():
    """Where every tile finds its predecessor's prefix out, the design is
    the plain versions' walk, to the bit; composed carries are not."""
    a, x, dh = map(t, _case_inputs(*CASES[4]))
    h = rglru_scan_plain(a, x)
    h_prev = torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))
    assert torch.equal(emulate_rglru_scan(a, x, "walked"), h)
    for got, want in zip(emulate_rglru_scan_bwd(a, h_prev, dh, "walked"),
                         rglru_scan_bwd_plain(a, h_prev, dh)):
        assert torch.equal(got, want)
    composed = [emulate_rglru_scan(a, x, order) for order in ORDERS[1:]]
    assert not any(torch.equal(c, h) for c in composed)


@pytest.mark.parametrize("order", ORDERS)
def test_a_dropped_carry_fails_tol_scan(order):
    """The same check sees one chunk's carry-in dropped, forward and
    backward, on the ragged case (four chunks, the last of 5 steps)."""
    case = CASES[-1]
    a, x, dh = _case_inputs(*case)
    h, h_prev, want_da, want_db = _jax(case)
    assert over_allowance(emulate_rglru_scan(t(a), t(x), order, drop=2), h) > 1
    da, db = emulate_rglru_scan_bwd(t(a), t(h_prev), t(dh), order, drop=1)
    assert over_allowance(da, want_da) > 1
    assert over_allowance(db, want_db) > 1
