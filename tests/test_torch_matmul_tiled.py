"""K1's and K4's tensor-core designs, on the CPU: what K1's ``wgmma-swapab``
and ``wgmma`` designs compute, emulated in plain PyTorch, against the JAX
package's ``matmul_mcast_tiled`` (Pallas, interpret mode), and the tiles
that ``kernel_blocks`` reports against the kernel sources.

The designs of ``csrc/matmul_tiled.cu`` (on ``csrc/matmul_wgmma.cuh``)
multiply bf16 by bf16 exactly and sum the products of each K split (a
run of 64-deep k-tiles) in fp32; the last CTA of a column tile sums the
splits' fp32 partials in split order, then adds the bias (bf16 or fp32,
widened), applies the activation and rounds once to ``out_dtype``.  JAX
sums in fp32 over 128-deep blocks and runs the same epilogue on its
flush.  The two differ by fp32 reordering, held to ``chip_smoke``'s
form ``|got - want| <= tol (1 + |want|)``: ``TOL_BF16`` 2e-2 for bf16
outputs (about two bf16 ulps: a reordered sum can round to the other
side of a tie), ``TOL_FP32`` 1e-4 for fp32 outputs."""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import t
from repro.kernels.matmul.matmul import matmul_mcast_tiled
from repro_torch.kernels.matmul import (
    ACT_CODES,
    ACTIVATIONS,
    kernel_blocks,
    matmul_mcast,
    matmul_tiled,
    mcast_cluster,
)
from repro_torch.kernels.matmul import matmul as mm
from test_torch_matmul_unicast import three_pieces


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Beside the suite's other workers, torch's default of one thread per
    core oversubscribes the CPU: each parallel region waits for threads
    that have no core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_BF16, TOL_FP32 = 2e-2, 1e-4  # chip_smoke.TOL_BF16, chip_smoke.TOL_FP32
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _constants() -> dict[str, int]:
    """The tile and rule constants of the kernel sources."""
    found = {}
    for name, pattern in (
            ("matmul_wgmma.cuh", r"\b(SMALL_M_MAX|SMALL_BN|LARGE_BM|LARGE_BN|SMS) = (\d+)"),
            ("matmul_hopper.cuh", r"constexpr int (BK) = (\d+)"),
            ("matmul_tiled.cu", r"constexpr int (GROUP_M) = (\d+)"),
            ("matmul_mcast.cu", r"\b(CLUSTER_SMALL|CLUSTER_LARGE|CLUSTER_SMALL_MAX_M) = (\d+)")):
        found.update((k, int(v)) for k, v in re.findall(pattern, (CSRC / name).read_text()))
    return found


def splits_of(n: int, k: int) -> int:
    """The K split of the swapab designs (matmul_wgmma.cuh ``splits_of``)."""
    c = _constants()
    tiles, steps = -(-n // c["SMALL_BN"]), -(-k // c["BK"])
    if tiles >= c["SMS"] or steps <= 1:
        return 1
    return min(-(-c["SMS"] // tiles), steps)


def tiled_emulated(a, b, bias, activation, out_dtype, splits):
    """C = act(A @ B + bias) as K1's tensor-core designs compute it: each
    split's share of the 64-deep k-tiles summed in fp32 (the exact products
    summed in fp64, rounded once), the splits summed in order in fp32, then
    the bias widened to fp32, the activation and one rounding.  fp32 A
    enters as its three bf16 pieces (wgmma-swapab-3xbf16)."""
    k = a.shape[1]
    tiles = -(-k // 64)
    pieces = three_pieces(a.float()) if a.dtype == torch.float32 else (a.float(),)
    total = None
    for p in range(splits):
        k0, k1 = tiles * p // splits * 64, min(tiles * (p + 1) // splits * 64, k)
        part = sum(piece[:, k0:k1].double() @ b[k0:k1].double() for piece in pieces).float()
        total = part if total is None else total + part
    if bias is not None:
        total = total + bias.float()
    return ACTIVATIONS[activation](total).to(out_dtype)


def _inputs(m, k, n, bias_dtype, seed, a_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = None if bias_dtype is None else rng.standard_normal(n).astype(np.float32)
    ja, jb = jnp.asarray(a, JNP[a_dtype]), jnp.asarray(b, jnp.bfloat16)
    jbias = None if bias is None else jnp.asarray(bias, JNP[bias_dtype])
    ta, tb = t(np.asarray(ja)), t(np.asarray(jb))
    return (ja, jb, jbias), (ta, tb, None if jbias is None else t(np.asarray(jbias)))


def _hold(got, want, out_dtype):
    tol = TOL_FP32 if out_dtype == torch.float32 else TOL_BF16
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol * (1 + w.abs())).all(), float(
        ((g - w).abs() / (1 + w.abs())).max())


def _both(m, k, n, *, activation, bias_dtype, out_dtype, splits, seed=0):
    (ja, jb, jbias), (ta, tb, tbias) = _inputs(m, k, n, bias_dtype, seed)
    want = t(np.asarray(matmul_mcast_tiled(ja, jb, jbias, activation=activation,
                                           out_dtype=JNP[out_dtype], interpret=True)))
    got = tiled_emulated(ta, tb, tbias, activation, out_dtype, splits)
    assert got.dtype == want.dtype == out_dtype
    return got, want


@pytest.mark.parametrize("bias_dtype", [None, torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("activation", ACT_CODES)
def test_swapab_split_epilogue_matches_pallas_every_activation(activation, bias_dtype):
    """wgmma-swapab at a ragged decode-like shape split 9 ways: the bias
    once after the whole K sum, the activation on the summed value."""
    m, k, n = 5, 589, 901
    assert splits_of(n, k) == 9
    got, want = _both(m, k, n, activation=activation, bias_dtype=bias_dtype,
                      out_dtype=torch.bfloat16, splits=9)
    _hold(got, want, torch.bfloat16)


# (m, k, n, the K split): ragged M, N and K at splits 1, 2 and 9 (M <= 64,
# wgmma-swapab), and M > 64 (wgmma: no split)
SPLIT_SHAPES = [(3, 61, 130, 1), (17, 100, 77, 2), (48, 589, 901, 9), (70, 200, 130, 1)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
def test_tensor_core_designs_match_pallas_out_dtypes_and_splits(shape, out_dtype):
    m, k, n, splits = shape
    assert (splits_of(n, k) if m <= 64 else 1) == splits  # gemm_wgmma: all of K in one CTA
    got, want = _both(m, k, n, activation="silu", bias_dtype=torch.float32,
                      out_dtype=out_dtype, splits=splits, seed=m)
    _hold(got, want, out_dtype)


@pytest.mark.parametrize("m,k,n", [(4, 256, 1000), (1, 64, 300), (48, 192, 130)])
def test_three_bf16_pieces_reproduce_the_fp32_logits_with_k1s_fp32_out(m, k, n):
    """wgmma-swapab-3xbf16 as K1 runs the tied logits (fp32 activations x
    4, the bf16 table x 0.02 read transposed, fp32 out, no bias) against
    JAX's kernel, within TOL_FP32 and far inside it."""
    rng = np.random.default_rng(m * k + n)
    a = (rng.standard_normal((m, k)) * 4).astype(np.float32)
    table = jnp.asarray(rng.standard_normal((n, k)) * 0.02, jnp.bfloat16)
    want = t(np.asarray(matmul_mcast_tiled(jnp.asarray(a), table.T, out_dtype=jnp.float32,
                                           interpret=True)))
    got = tiled_emulated(torch.from_numpy(a), t(np.asarray(table)).t(), None, "none",
                         torch.float32, splits_of(n, k))
    assert want.dtype == got.dtype == torch.float32
    err = (got - want).abs()
    assert (err <= TOL_FP32 * (1 + want.abs())).all()
    assert float((err / (1 + want.abs())).max()) < TOL_FP32 / 10


def test_splits_of_is_the_kernel_rule_at_the_serving_shapes():
    """The K splits recorded for the decode shapes: 9 at 4 x 1024 x 1024
    and 4 x 2816 x 1024, 3 at N = 2816, none for the logits."""
    assert [splits_of(n, k) for k, n in ((1024, 1024), (2816, 1024), (1024, 2816),
                                         (1024, 151936))] == [9, 9, 3, 1]


@pytest.mark.parametrize("m", [1, 4, 48, 64, 65, 129, 256, 257, 300, 2049])
def test_kernel_blocks_tiled_and_mcast_are_the_kernel_tiles(m):
    """``kernel_blocks(m)["tiled"]`` and ``["mcast"]`` are the tiles of the
    kernel sources: one row block of SMALL_M_MAX rows and SMALL_BN columns
    up to SMALL_M_MAX rows, then LARGE_BM x LARGE_BN; K1's supertile gm is
    GROUP_M row blocks, K4's bm is its cluster of CL row blocks by its
    rule, so ceil(m / bm) is how often K4 fetches B."""
    c = _constants()
    assert {"SMALL_M_MAX", "SMALL_BN", "LARGE_BM", "LARGE_BN", "BK", "GROUP_M",
            "CLUSTER_SMALL", "CLUSTER_LARGE", "CLUSTER_SMALL_MAX_M"} <= set(c)
    assert (mm.MCAST_CLUSTER_SMALL, mm.MCAST_CLUSTER_LARGE, mm.MCAST_CLUSTER_SMALL_MAX_M) == (
        c["CLUSTER_SMALL"], c["CLUSTER_LARGE"], c["CLUSTER_SMALL_MAX_M"])
    blocks = kernel_blocks(m)
    gm = c["GROUP_M"] * c["LARGE_BM"]
    if m <= c["SMALL_M_MAX"]:
        small = dict(bm=c["SMALL_M_MAX"], bn=c["SMALL_BN"], bk=c["BK"])
        assert blocks["tiled"] == dict(small, gm=gm) and blocks["mcast"] == small
        return
    cl = c["CLUSTER_SMALL"] if m <= c["CLUSTER_SMALL_MAX_M"] else c["CLUSTER_LARGE"]
    assert mcast_cluster(m) == cl
    large = dict(bm=c["LARGE_BM"], bn=c["LARGE_BN"], bk=c["BK"])
    assert blocks["tiled"] == dict(large, gm=gm)
    assert blocks["mcast"] == dict(large, bm=cl * c["LARGE_BM"])


def test_mcast_cluster_rule_fetches_b_once_at_256_rows_and_five_times_at_2049():
    reads = {m: math.ceil(m / kernel_blocks(m)["mcast"]["bm"]) for m in (256, 512, 2049)}
    assert reads == {256: 1, 512: 1, 2049: 5}
    assert mcast_cluster(256) == 2


def test_cpu_wrappers_run_the_plain_version_and_leave_the_design_alone():
    """On the CPU K1 and K4 take their plain versions whatever design the
    card would run, with a bf16 bias too, and leave the design and launch
    count alone."""
    a = torch.randn(4, 64).to(torch.bfloat16)
    b = torch.randn(64, 300).to(torch.bfloat16)
    bias = torch.randn(300).to(torch.bfloat16)
    before = (matmul_tiled.launches, matmul_mcast.launches)
    y = matmul_tiled(a, b, bias, activation="silu", out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (4, 300)
    assert matmul_mcast(a, b).shape == (4, 300)
    assert (matmul_tiled.launches, matmul_mcast.launches) == before
    assert matmul_tiled.design is None and matmul_mcast.design is None
