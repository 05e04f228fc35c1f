"""K5's tensor-core designs, on the CPU: the arithmetic of the fp32 x bf16
route (the tied logits) emulated in plain PyTorch against the JAX
package's ``matmul_unicast`` (Pallas, interpret mode), and the tile
constants that ``kernel_blocks`` reports against the kernel source.

The ``wgmma-swapab-3xbf16`` design of ``csrc/matmul_unicast.cu`` reads
each fp32 k-tile of A and splits it into three bf16 pieces, ``a1 =
bf16(a)``, ``a2 = bf16(a - a1)``, ``a3 = bf16(a - a1 - a2)``; each piece
times the bf16 B is exact in fp32, and the tensor cores sum the products
in fp32.  JAX multiplies ``a`` by ``b`` widened to fp32.  The pieces hold
a to about 2^-24 of |a|, so the two sums differ by fp32 reordering:
``chip_smoke.TOL_FP32`` (1e-4 of the element, and absolute) holds them."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.matmul.matmul import matmul_unicast as jax_unicast
from repro_torch.kernels.matmul import kernel_blocks, matmul_unicast


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_FP32 = 1e-4  # chip_smoke.TOL_FP32: rtol and atol of the fp32 logits
SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/matmul_unicast.cu"


def _bf16(x):
    return x.to(torch.bfloat16).float()


def three_pieces(a):
    """fp32 a as three bf16 pieces, largest first (the kernel's split)."""
    a1 = _bf16(a)
    a2 = _bf16(a - a1)
    return a1, a2, _bf16(a - a1 - a2)


def unicast_3xbf16(a, b):
    """C = A @ B as the 3xbf16 K5 computes it: each piece of A times the
    bf16 B, summed in fp32; C in fp32."""
    bf = b.float()
    out = torch.zeros(a.shape[0], b.shape[1])
    for piece in three_pieces(a.float()):
        out = out + piece @ bf
    return out


@pytest.mark.parametrize("m,k,n", [(4, 256, 1000), (1, 64, 300), (48, 192, 130)])
def test_three_bf16_pieces_reproduce_the_fp32_logits(m, k, n):
    """The emulated split against JAX's kernel on the logits' operands
    (fp32 activations x 4, the bf16 table x 0.02 read transposed), within
    the card's fp32 tolerance, and far inside it."""
    rng = np.random.default_rng(m * k + n)
    a = (rng.standard_normal((m, k)) * 4).astype(np.float32)
    table = jnp.asarray(rng.standard_normal((n, k)) * 0.02, jnp.bfloat16)
    want = t(np.asarray(jax_unicast(jnp.asarray(a), table.T, bm=8, bn=128, bk=64,
                                    interpret=True)))
    got = unicast_3xbf16(torch.from_numpy(a), t(np.asarray(table)).t())
    assert want.dtype == got.dtype == torch.float32
    err = (got - want).abs()
    assert (err <= TOL_FP32 * (1 + want.abs())).all()
    assert float((err / (1 + want.abs())).max()) < TOL_FP32 / 10


def test_three_pieces_hold_fp32_to_its_last_bit():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    x = x * torch.logspace(-6, 6, 10000)
    a1, a2, a3 = three_pieces(x)
    assert ((a1 + a2 + a3 - x).abs() <= x.abs() * 2.0**-24).all()


def test_cpu_wrapper_runs_the_plain_version_for_every_design():
    """On the CPU the wrapper takes the plain version whatever design the
    card would run, and leaves the design and the launch count alone."""
    a = torch.randn(4, 64)
    b = torch.randn(300, 64).to(torch.bfloat16).t()
    before = matmul_unicast.launches
    got = matmul_unicast(a, b)
    assert got.dtype == torch.float32 and got.shape == (4, 300)
    assert matmul_unicast.launches == before and matmul_unicast.design is None


def _constants():
    """K5's tiles: its tensor-core kernels are matmul_wgmma.cuh's."""
    text = (SOURCE.parent / "matmul_wgmma.cuh").read_text()
    return {name: int(val) for name, val in
            re.findall(r"\b(SMALL_M_MAX|SMALL_BN|LARGE_BM|LARGE_BN|BK) = (\d+)", text)
            + re.findall(r"constexpr int (BK) = (\d+)", (SOURCE.parent / "matmul_hopper.cuh")
                         .read_text())}


@pytest.mark.parametrize("m", [1, 4, 48, 64, 65, 256, 2049])
def test_kernel_blocks_unicast_are_the_kernel_tiles(m):
    """``kernel_blocks(m)["unicast"]`` is the tile K5's tensor-core design
    runs at m rows: one row block of every row up to SMALL_M_MAX (SMALL_BN
    columns), then LARGE_BM x LARGE_BN; BK deep."""
    c = _constants()
    assert {"SMALL_M_MAX", "SMALL_BN", "LARGE_BM", "LARGE_BN", "BK"} <= set(c)
    want = dict(bm=c["SMALL_M_MAX"], bn=c["SMALL_BN"], bk=c["BK"]) if m <= c["SMALL_M_MAX"] \
        else dict(bm=c["LARGE_BM"], bn=c["LARGE_BN"], bk=c["BK"])
    assert kernel_blocks(m)["unicast"] == want
