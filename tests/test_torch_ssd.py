"""The port's SSD scan (``repro_torch.kernels.ssd``: K9's and K10's plain
versions, the sequential oracle, the within-chunk cumsum) against the JAX
package's Pallas kernels in interpret mode and its oracle.

Inputs come from a numpy seed and the JAX tests' draws: xdt, B and C
~ 0.5 N(0, 1), log a = -softplus(N(0, 1)).  Stated tolerance: 5e-4
absolute and relative, the JAX package's own for these kernels (fp32,
the two sides sum in other orders).  The port's CUDA chunk is 64 and its
last chunk may be short; the JAX kernel's chunk must divide the sequence,
so where it does not (s = 200) each side runs its own chunk and the
function, not the chunking, is compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.api import _ssd_lcum as jax_ssd_lcum
from repro.kernels.ssd.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd.ssd import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ssd import ssd_scan_bwd as jax_ssd_scan_bwd
from repro_torch import kernels
from repro_torch.kernels.ssd import (
    SSD_CHUNK,
    ssd_lcum,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
    ssd_scan_ref,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=5e-4, atol=5e-4)

# (b, h, s, P, N, the JAX kernel's chunk, the port's chunk): the shapes of
# the JAX package's kernel test, then s = 192 (the port's 64 divides it)
# and s = 200 (no chunk in 32..256 divides it: the port runs 3 full
# chunks and one of 8 steps, JAX two chunks of 100)
CASES = [
    (1, 2, 256, 64, 32, 64, 64),
    (2, 3, 128, 32, 64, 32, 32),
    (1, 4, 512, 64, 128, 128, 128),
    (1, 2, 192, 32, 16, 64, SSD_CHUNK),
    (1, 3, 200, 32, 16, 100, SSD_CHUNK),
]


def _inputs(b, h, s, p, n, seed=0):
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, h, s, p)) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    log_a = -np.logaddexp(0.0, rng.standard_normal((b, h, s))).astype(np.float32)
    dy = rng.standard_normal((b, h, s, p)).astype(np.float32)
    return xdt, bm, cm, log_a, dy


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ssd_plain_matches_the_jax_kernel(case):
    b, h, s, p, n, jax_chunk, chunk = case
    xdt, bm, cm, log_a, _ = _inputs(b, h, s, p, n)
    lc_jax = jax_ssd_lcum(jnp.asarray(log_a), jax_chunk)
    want, want_states = jax_ssd_scan(jnp.asarray(xdt), jnp.asarray(bm), jnp.asarray(cm), lc_jax,
                                     chunk=jax_chunk, return_states=True, interpret=True)
    y, states = ssd_scan_plain(t(xdt), t(bm), t(cm), ssd_lcum(t(log_a), chunk), chunk=chunk,
                               return_states=True)
    assert y.dtype == states.dtype == torch.float32
    assert tuple(states.shape) == (b, h, -(-s // chunk), p, n)
    _close(y, want)
    if chunk == jax_chunk:  # the same checkpoints
        _close(states, want_states)


@pytest.mark.parametrize("case", CASES[:2] + CASES[-1:], ids=str)
def test_ssd_ref_matches_the_jax_ref(case):
    b, h, s, p, n, _, _ = case
    xdt, bm, cm, log_a, _ = _inputs(b, h, s, p, n, seed=1)
    want = jax_ssd_scan_ref(*map(jnp.asarray, (xdt, bm, cm, log_a)))
    _close(ssd_scan_ref(t(xdt), t(bm), t(cm), t(log_a)), want)


@pytest.mark.parametrize("s,chunk", [(256, 64), (192, 64), (200, 64), (100, 32)])
def test_ssd_lcum_is_the_within_chunk_cumsum(s, chunk):
    log_a = _inputs(1, 2, s, 1, 1)[3]
    got = ssd_lcum(t(log_a), chunk)
    assert got.is_contiguous() and tuple(got.shape) == (1, 2, s, 1)
    if s % chunk == 0:
        _close(got, jax_ssd_lcum(jnp.asarray(log_a), chunk))
    starts = np.arange(0, s, chunk)
    want = np.concatenate([np.cumsum(log_a[..., i:i + chunk], axis=-1) for i in starts], -1)
    _close(got[..., 0], want)


@pytest.mark.parametrize("case", CASES[:2] + CASES[3:4], ids=str)
def test_ssd_bwd_plain_matches_the_jax_kernel(case):
    """Same chunk, and the checkpoints of JAX's own ``return_states``."""
    b, h, s, p, n, chunk, _ = case
    xdt, bm, cm, log_a, dy = _inputs(b, h, s, p, n, seed=2)
    lc = jax_ssd_lcum(jnp.asarray(log_a), chunk)
    _, states = jax_ssd_scan(jnp.asarray(xdt), jnp.asarray(bm), jnp.asarray(cm), lc,
                             chunk=chunk, return_states=True, interpret=True)
    want = jax_ssd_scan_bwd(jnp.asarray(xdt), jnp.asarray(bm), jnp.asarray(cm), lc, states,
                            jnp.asarray(dy), chunk=chunk, interpret=True)
    got = ssd_scan_bwd_plain(t(xdt), t(bm), t(cm), t(lc), t(states), t(dy), chunk=chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("s", [200, 130])
def test_ssd_short_last_chunk_adjoint_matches_autograd_through_the_oracle(s):
    """The padded last chunk changes no gradient: K10's plain version (the
    checkpoints of K9's) against PyTorch's autograd through the sequential
    oracle, which has no chunks at all."""
    xdt, bm, cm, log_a, dy = map(t, _inputs(1, 2, s, 16, 8, seed=3))
    y, states = ssd_scan_plain(xdt, bm, cm, ssd_lcum(log_a, SSD_CHUNK), return_states=True)
    dx, db, dc, dl = ssd_scan_bwd_plain(xdt, bm, cm, ssd_lcum(log_a, SSD_CHUNK), states, dy)
    leaves = [x.clone().requires_grad_() for x in (xdt, bm, cm, log_a)]
    ref = ssd_scan_ref(*leaves)
    want = torch.autograd.grad((ref * dy).sum(), leaves)
    _close(y, ref.detach())
    for g, w in zip((dx, db.sum(1), dc.sum(1), dl[..., 0]), want):
        _close(g, w)


def test_ssd_wrappers_run_the_plain_versions_on_cpu_tensors():
    xdt, bm, cm, log_a, dy = map(t, _inputs(1, 2, 70, 8, 4, seed=4))
    lc = ssd_lcum(log_a, SSD_CHUNK)
    kernels.reset_launch_counts()
    y, states = ssd_scan(xdt, bm, cm, lc, return_states=True)
    torch.testing.assert_close(y, ssd_scan_plain(xdt, bm, cm, lc), rtol=0, atol=0)
    for g, w in zip(ssd_scan_bwd(xdt, bm, cm, lc, states, dy),
                    ssd_scan_bwd_plain(xdt, bm, cm, lc, states, dy)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


def test_ssd_shape_rules():
    xdt, bm, cm, log_a, dy = map(t, _inputs(1, 2, 64, 8, 4, seed=5))
    lc = ssd_lcum(log_a, SSD_CHUNK)
    with pytest.raises(ValueError, match="lcum"):
        ssd_scan_plain(xdt, bm, cm, lc[:, :1])
    with pytest.raises(ValueError, match="states"):
        ssd_scan_bwd_plain(xdt, bm, cm, lc, torch.zeros(1, 2, 2, 8, 4), dy)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd_plain(xdt, bm, cm, lc, torch.zeros(1, 2, 1, 8, 4), dy[..., :4])
