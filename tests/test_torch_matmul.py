"""K1 (tiled multicast matmul) of the port against the JAX package's
``matmul_mcast_tiled`` Pallas kernel, run in interpret mode.

The same numpy-seeded inputs go to both sides.  The comparison is with
the Pallas kernel itself, not with JAX's CPU default backend, whose
epilogue rounds to ``out_dtype`` before the bias add."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import close, t
from repro.kernels.matmul.matmul import matmul_mcast_tiled
from repro_torch import kernels
from repro_torch.kernels.matmul import (
    ACTIVATIONS,
    matmul_ref,
    matmul_tiled,
    matmul_tiled_plain,
)

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(m, k, n, dtype, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((m, k)), JNP[dtype])
    b = jnp.asarray(rng.standard_normal((k, n)) / np.sqrt(k), JNP[dtype])
    bb = jnp.asarray(rng.standard_normal(n), JNP[dtype]) if bias else None
    return a, b, bb


def _both(a, b, bias, **kw):
    want = matmul_mcast_tiled(a, b, bias, interpret=True, **kw)
    out_dtype = kw.get("out_dtype")
    tdt = {None: None, jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[out_dtype]
    got = matmul_tiled(t(a), t(b), None if bias is None else t(bias),
                       activation=kw.get("activation", "none"), out_dtype=tdt)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_plain_matches_pallas_every_activation(dtype, activation):
    a, b, bias = _inputs(24, 96, 40, dtype)
    got, want = _both(a, b, bias, activation=activation)
    assert got.dtype == dtype
    close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_without_bias(dtype):
    a, b, _ = _inputs(16, 64, 48, dtype, bias=False)
    got, want = _both(a, b, None)
    close(got, want)


@pytest.mark.parametrize("shape", [(5, 70, 33), (1, 130, 257), (37, 9, 3)])
def test_plain_matches_pallas_ragged_shapes(shape):
    """Non-divisible M/N/K: the TPU kernel zero-pads, K1 masks."""
    a, b, bias = _inputs(*shape, torch.bfloat16, seed=1)
    got, want = _both(a, b, bias, activation="silu")
    close(got, want)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, jnp.float32), (torch.float32, jnp.bfloat16)])
def test_plain_matches_pallas_out_dtype(in_dtype, out_dtype):
    a, b, bias = _inputs(12, 80, 24, in_dtype, seed=2)
    got, want = _both(a, b, bias, activation="gelu", out_dtype=out_dtype)
    assert got.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[out_dtype]
    close(got, want)


def test_transposed_bf16_table_is_the_fp32_logits_product():
    """The tied logits: JAX multiplies by ``table.T.astype(f32)``; K1
    reads the bf16 table through a transposed view and widens it — the
    same fp32 function with no fp32 copy of the table."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((4, 64)), jnp.float32)
    table = jnp.asarray(rng.standard_normal((300, 64)) * 0.02, jnp.bfloat16)
    want = matmul_mcast_tiled(x, table.T.astype(jnp.float32), interpret=True)
    view = t(table).t()
    assert not view.is_contiguous() and view.dtype == torch.bfloat16
    got = kernels.linear(t(x), view)
    assert got.dtype == torch.float32
    close(got, want)


def test_linear_contracts_leading_dims_like_the_reference():
    """``contract_dims=2`` flattens (heads, head_dim) like the JAX ``wo``."""
    rng = np.random.default_rng(5)
    o = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8, 16)).astype(np.float32)
    got = kernels.linear(torch.from_numpy(o), torch.from_numpy(w), contract_dims=2)
    want = matmul_mcast_tiled(jnp.asarray(o.reshape(6, 32)), jnp.asarray(w.reshape(32, 16)),
                              interpret=True)
    assert got.shape == (2, 3, 16)
    close(got.reshape(6, 16), want)


def test_ref_oracle_matches_plain():
    a = torch.randn(9, 33, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    b = torch.randn(33, 7, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    close(matmul_ref(a, b), matmul_tiled_plain(a, b).float().numpy())


def test_cpu_wrapper_rejects_bad_inputs():
    a = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="activation"):
        matmul_tiled(a, torch.zeros(4, 2), activation="tanh")
    with pytest.raises(ValueError):
        matmul_tiled(a, torch.zeros(5, 2))
    with pytest.raises(TypeError):
        matmul_tiled(a.half(), torch.zeros(4, 2).half())
