"""The port's RG-LRU scan (``repro_torch.kernels.rglru``: K11's and
K12's plain versions and the sequential oracle) against the JAX
package's Pallas kernels in interpret mode and its oracle.

Inputs come from a numpy seed and the JAX tests' draws: a = 0.8 + 0.2
sigmoid(N(0, 1)), b ~ N(0, 1).  Stated tolerance: 1e-4 absolute and
relative, the JAX package's own (fp32; JAX's interpreter may fuse a
multiply-add the port rounds twice)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro.kernels.rglru.rglru import rglru_scan as jax_rglru_scan
from repro.kernels.rglru.rglru import rglru_scan_bwd as jax_rglru_scan_bwd
from repro_torch import kernels
from repro_torch.kernels.rglru import (
    rglru_scan,
    rglru_scan_bwd,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
    rglru_scan_ref,
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


TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX package's kernel-test shapes, then (192, 192): no 128-multiple
# block divides it, so the JAX kernel runs one 192 x 192 block
SHAPES = [(2, 512, 256), (1, 256, 512), (3, 128, 128), (2, 192, 192)]


def _inputs(b, s, d, seed=0):
    rng = np.random.default_rng(seed)
    a = (0.8 + 0.2 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dh = rng.standard_normal((b, s, d)).astype(np.float32)
    return a, x, dh


def _blocks(s, d):
    return dict(bs=128 if s % 128 == 0 else s, bd=128 if d % 128 == 0 else d)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rglru_plain_matches_the_jax_kernel_and_oracle(shape):
    a, x, _ = _inputs(*shape)
    got = rglru_scan_plain(t(a), t(x))
    assert got.dtype == torch.float32
    _close(got, jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), **_blocks(*shape[1:]),
                               interpret=True))
    _close(rglru_scan_ref(t(a), t(x)), jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(x)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_rglru_bwd_plain_matches_the_jax_kernel(shape):
    a, x, dh = _inputs(*shape, seed=1)
    h = np.asarray(jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(x)))
    h_prev = np.concatenate([np.zeros_like(h[:, :1]), h[:, :-1]], axis=1)
    want = jax_rglru_scan_bwd(jnp.asarray(a), jnp.asarray(h_prev), jnp.asarray(dh),
                              **_blocks(*shape[1:]), interpret=True)
    got = rglru_scan_bwd_plain(t(a), t(h_prev), t(dh))
    for g, w in zip(got, want):
        _close(g, w)


def test_rglru_wrappers_run_the_plain_versions_on_cpu_tensors():
    a, x, dh = map(t, _inputs(2, 40, 24, seed=2))
    kernels.reset_launch_counts()
    h = rglru_scan(a, x)
    torch.testing.assert_close(h, rglru_scan_plain(a, x), rtol=0, atol=0)
    for g, w in zip(rglru_scan_bwd(a, h, dh), rglru_scan_bwd_plain(a, h, dh)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


def test_rglru_shape_rules():
    a, x, dh = map(t, _inputs(1, 8, 4))
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_plain(a, x[:, :4])
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_bwd_plain(a, a, dh[..., :2])
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_plain(a[0], x[0])
