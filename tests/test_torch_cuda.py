"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (the ``cuda_device`` fixture)
and skips without one; this file imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from _torch_util import close, cuda_device  # noqa: F401 (fixture)
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.launch.serve import Server
from repro_torch.kernels.matmul import (
    ACTIVATIONS,
    matmul_mcast,
    matmul_mcast_plain,
    matmul_tiled,
    matmul_tiled_plain,
    matmul_unicast,
    matmul_unicast_plain,
)
from repro_torch.kernels.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_prefill,
    paged_attention_prefill_plain,
)
from repro_torch.models import lm
from repro_torch.serve import PagedEngine, Request


def _rand(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)


@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (48, 1024, 2816), (5, 70, 33),
                                   (17, 2816, 1024)])
@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_matmul_kernel_matches_plain(cuda_device, m, k, n, activation):
    gen = torch.Generator(device=cuda_device).manual_seed(m * n)
    a, b = _rand(gen, m, k), _rand(gen, k, n, scale=k ** -0.5)
    bias = _rand(gen, n)
    before = matmul_tiled.launches
    got = matmul_tiled(a, b, bias, activation=activation)
    torch.cuda.synchronize()
    assert matmul_tiled.launches == before + 1
    close(got.cpu(), matmul_tiled_plain(a, b, bias, activation=activation).float().cpu())


@pytest.mark.parametrize("a_dtype,b_dtype,out_dtype", [
    (torch.float32, torch.float32, torch.float32), (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32)])
def test_matmul_kernel_dtypes_and_strides(cuda_device, a_dtype, b_dtype, out_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = _rand(gen, 6, 300, dtype=a_dtype)
    table = _rand(gen, 999, 300, dtype=b_dtype, scale=0.05)  # read as a transposed view
    got = matmul_tiled(a, table.t(), out_dtype=out_dtype)
    want = matmul_tiled_plain(a, table.t(), out_dtype=out_dtype)
    torch.cuda.synchronize()
    close(got.cpu(), want.float().cpu(), out_dtype)


FLAT = {"matmul_mcast": (matmul_mcast, matmul_mcast_plain),
        "matmul_unicast": (matmul_unicast, matmul_unicast_plain)}


@pytest.mark.parametrize("name", sorted(FLAT))
@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (48, 1024, 2816), (5, 70, 33),
                                   (17, 2816, 1024), (256, 256, 200), (300, 130, 77),
                                   (1, 1, 1)])
def test_flat_matmul_kernel_matches_plain(cuda_device, name, m, k, n):
    """K4/K5 on ragged shapes, below and above K4's 256 resident rows."""
    fn, plain = FLAT[name]
    gen = torch.Generator(device=cuda_device).manual_seed(m + n)
    a, b = _rand(gen, m, k), _rand(gen, k, n, scale=k ** -0.5)
    before = fn.launches
    got = fn(a, b)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    close(got.cpu(), plain(a, b).float().cpu())


@pytest.mark.parametrize("name", sorted(FLAT))
@pytest.mark.parametrize("a_dtype,b_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m", [6, 300])
def test_flat_matmul_kernel_dtypes_and_strides(cuda_device, name, a_dtype, b_dtype, m):
    """Mixed storage dtypes, B read as a transposed view; C in a's dtype."""
    fn, plain = FLAT[name]
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    a = _rand(gen, m, 300, dtype=a_dtype)
    table = _rand(gen, 999, 300, dtype=b_dtype, scale=0.05)
    got = fn(a, table.t())
    want = plain(a, table.t())
    torch.cuda.synchronize()
    assert got.dtype == a_dtype
    close(got.cpu(), want.float().cpu())


def test_flat_matmul_kernels_reject_bad_inputs(cuda_device):
    a = torch.zeros(3, 4, device=cuda_device)
    for fn, _ in FLAT.values():
        with pytest.raises(ValueError):
            fn(a, torch.zeros(5, 2, device=cuda_device))
        with pytest.raises(TypeError):
            fn(a.half(), torch.zeros(4, 2, device=cuda_device).half())
        with pytest.raises(ValueError, match="CUDA"):
            fn(a, torch.zeros(4, 2))


def _shifted(t):
    """t's values in a contiguous tensor whose base is one element (2 or 4
    bytes) past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


# (m, k, n, form, design): K5's four designs by its C rule — bf16 A and B
# at M <= 64 (swap AB, split K) and above it (128 x 128 tiles), A or B read
# as a transposed view (A must be K-major below 65 rows), the fp32 x bf16
# tied logits, and what stays on the CUDA cores (fp32 B, a misaligned
# base, mixed dtypes above 64 rows)
UNICAST_CASES = [
    (1, 1024, 1024, "bf16", "wgmma-swapab"),
    (4, 1024, 1024, "bf16", "wgmma-swapab"),
    (4, 2816, 1024, "bf16", "wgmma-swapab"),
    (16, 320, 200, "bf16", "wgmma-swapab"),
    (48, 1024, 2816, "bf16", "wgmma-swapab"),
    (64, 512, 136, "bf16", "wgmma-swapab"),
    (65, 256, 200, "bf16", "wgmma"),
    (256, 1024, 2816, "bf16", "wgmma"),
    (2049, 1024, 2816, "bf16", "wgmma"),
    (4, 1024, 2816, "a.t()", "cuda-core"),
    (256, 1024, 2816, "a.t()", "wgmma"),
    (4, 1024, 2816, "b.t()", "wgmma-swapab"),
    (2049, 1024, 2816, "b.t()", "wgmma"),
    (4, 1024, 151936, "logits", "wgmma-swapab-3xbf16"),
    (48, 1000, 3000, "logits", "wgmma-swapab-3xbf16"),
    (4, 1024, 1024, "misaligned a", "cuda-core"),
    (256, 1024, 1024, "misaligned b", "cuda-core"),
    (4, 1024, 1024, "fp32 b", "cuda-core"),
    (65, 256, 200, "logits", "cuda-core"),
]


@pytest.mark.parametrize("case", UNICAST_CASES, ids=str)
def test_unicast_designs_by_rule_match_plain(cuda_device, case):
    """K5 runs the design its C entry's fixed rule names for the operands
    (``matmul_unicast.design``) and agrees with its plain version: bf16
    outputs within 2e-2; fp32 outputs within 1e-5, and the 3xbf16 logits
    within chip_smoke's TOL_FP32 of 1e-4 (the tensor cores add the three
    pieces' exact products in their own fp32 accumulation, not in IEEE
    order: 2.8e-5 at most at |C| ~ 1-10 on an H100)."""
    m, k, n, form, design = case
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a_dtype = torch.float32 if form == "logits" else torch.bfloat16
    a = _rand(gen, k, m).t() if form == "a.t()" else _rand(gen, m, k, dtype=a_dtype,
                                                          scale=4.0 if form == "logits" else 1.0)
    if form in ("b.t()", "logits"):
        b = _rand(gen, n, k, scale=0.02 if form == "logits" else k ** -0.5).t()
    else:
        b = _rand(gen, k, n, dtype=torch.float32 if form == "fp32 b" else torch.bfloat16,
                  scale=k ** -0.5)
    if form == "misaligned a":
        a = _shifted(a)
    if form == "misaligned b":
        b = _shifted(b)
    before = matmul_unicast.launches
    got = matmul_unicast(a, b)
    torch.cuda.synchronize()
    assert matmul_unicast.launches == before + 1
    assert matmul_unicast.design == design
    assert got.dtype == a.dtype and got.shape == (m, n)
    want = matmul_unicast_plain(a, b).float().cpu()
    if design == "wgmma-swapab-3xbf16":
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    else:
        close(got.cpu(), want)


def test_unicast_split_k_is_deterministic_and_leaves_its_counters_at_zero(cuda_device):
    """wgmma-swapab splits K at 4 x 2816 x 1024 (16 column tiles): the last
    CTA of each tile sums the partials in split order, so two launches give
    the same bits, and resets the tile's counter for the next launch."""
    from repro_torch.kernels.matmul import matmul as mm

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    a, b = _rand(gen, 4, 2816), _rand(gen, 2816, 1024, scale=2816 ** -0.5)
    first, second = matmul_unicast(a, b), matmul_unicast(a, b)
    torch.cuda.synchronize()
    assert matmul_unicast.design == "wgmma-swapab"
    assert torch.equal(first, second)
    assert int(mm._UNICAST_COUNTERS[a.device].abs().sum()) == 0


# (m, k, n, form, design) of K1 (matmul_tiled) and K4 (matmul_mcast): the
# rule of csrc/matmul_wgmma.cuh for each — up to 64 rows wgmma-swapab (bf16
# A, K-major) or wgmma-swapab-3xbf16 (fp32 A), above it K1's wgmma (A K- or
# M-major) and K4's wgmma-cluster (K-major A only, clusters of 2 up to 256
# rows, else 4; 129, 300 and 2049 rows leave CTAs of a cluster idle or
# partly idle), and the CUDA-core kernel where B is not TMA-readable (N =
# 77: a row of 154 bytes), A is M-major above 64 rows (K4) or a base is
# misaligned
SCHEDULE_CASES = [
    (1, 1024, 1024, "bf16", "wgmma-swapab", "wgmma-swapab"),
    (5, 1024, 2816, "bf16", "wgmma-swapab", "wgmma-swapab"),
    (17, 2816, 1024, "bf16", "wgmma-swapab", "wgmma-swapab"),
    (48, 1024, 2816, "bf16", "wgmma-swapab", "wgmma-swapab"),
    (64, 512, 136, "bf16", "wgmma-swapab", "wgmma-swapab"),
    (65, 256, 200, "bf16", "wgmma", "wgmma-cluster"),
    (129, 1024, 1024, "bf16", "wgmma", "wgmma-cluster"),
    (300, 320, 520, "bf16", "wgmma", "wgmma-cluster"),
    (2049, 1024, 2816, "bf16", "wgmma", "wgmma-cluster"),
    (48, 1024, 77, "bf16", "cuda-core", "cuda-core"),
    (300, 256, 77, "bf16", "cuda-core", "cuda-core"),
    (5, 1024, 2816, "b.t()", "wgmma-swapab", "wgmma-swapab"),
    (2049, 1024, 2816, "b.t()", "wgmma", "wgmma-cluster"),
    (264, 1024, 2816, "a.t()", "wgmma", "cuda-core"),
    (5, 1024, 2816, "a.t()", "cuda-core", "cuda-core"),
    (4, 1024, 151936, "logits", "wgmma-swapab-3xbf16", "wgmma-swapab-3xbf16"),
    (48, 1000, 3000, "logits", "wgmma-swapab-3xbf16", "wgmma-swapab-3xbf16"),
    (4, 1024, 1024, "misaligned a", "cuda-core", "cuda-core"),
]


def _schedule_operands(gen, m, k, n, form):
    a_dtype = torch.float32 if form == "logits" else torch.bfloat16
    a = _rand(gen, k, m).t() if form == "a.t()" else _rand(gen, m, k, dtype=a_dtype,
                                                          scale=4.0 if form == "logits" else 1.0)
    if form in ("b.t()", "logits"):
        b = _rand(gen, n, k, scale=0.02 if form == "logits" else k ** -0.5).t()
    else:
        b = _rand(gen, k, n, scale=k ** -0.5)
    return (_shifted(a) if form == "misaligned a" else a), b


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=str)
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32], ids=str)
def test_tiled_designs_by_rule_match_plain(cuda_device, case, bias_dtype):
    """K1 runs the design its C rule names (``matmul_tiled.design``) and
    agrees with its plain version, with a bias read in its own dtype and
    silu fused: bf16 outputs within 2e-2; fp32 outputs within chip_smoke's
    TOL_FP32 of 1e-4 (the 3xbf16 logits add the pieces' exact products in
    the tensor cores' fp32 order)."""
    m, k, n, form, design, _ = case
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a, b = _schedule_operands(gen, m, k, n, form)
    bias = _rand(gen, n, dtype=bias_dtype)
    before = matmul_tiled.launches
    got = matmul_tiled(a, b, bias, activation="silu")
    torch.cuda.synchronize()
    assert matmul_tiled.launches == before + 1
    assert matmul_tiled.design == design
    assert got.dtype == a.dtype and got.shape == (m, n)
    want = matmul_tiled_plain(a, b, bias, activation="silu").float().cpu()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    else:
        close(got.cpu(), want)


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=str)
def test_mcast_designs_by_rule_match_plain(cuda_device, case):
    """K4 runs the design its C rule names (``matmul_mcast.design``) and
    agrees with its plain version, at the tolerances of K5's test."""
    m, k, n, form, _, design = case
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a, b = _schedule_operands(gen, m, k, n, form)
    before = matmul_mcast.launches
    got = matmul_mcast(a, b)
    torch.cuda.synchronize()
    assert matmul_mcast.launches == before + 1
    assert matmul_mcast.design == design
    assert got.dtype == a.dtype and got.shape == (m, n)
    want = matmul_mcast_plain(a, b).float().cpu()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    else:
        close(got.cpu(), want)


# (m, k, n, form, activation) at the projections of the last model
# families: gemma2-9b's q, k / v, o, GLU gate (gelu_tanh) and down and tied
# logits; command-r-35b's q / o, k / v, GLU gate (silu), down and tied
# logits; pixtral-12b's front end (also over two images' 512 patches) and
# untied head; whisper-medium's MLP in (gelu), its tied logits (N 51,865,
# odd) and its encoder input over two 1,500-frame clips
FAMILY_CASES = [
    (4, 3584, 4096, "bf16", "none"), (4, 3584, 2048, "bf16", "none"),
    (45, 4096, 3584, "bf16", "none"), (4, 3584, 14336, "bf16", "gelu_tanh"),
    (45, 14336, 3584, "bf16", "none"), (4, 3584, 256000, "logits", "none"),
    (4, 8192, 8192, "bf16", "none"), (45, 8192, 1024, "bf16", "none"),
    (4, 8192, 22528, "bf16", "silu"), (4, 22528, 8192, "bf16", "none"),
    (4, 8192, 256000, "logits", "none"), (4, 1024, 5120, "bf16", "none"),
    (512, 1024, 5120, "bf16", "none"), (4, 5120, 131072, "untied", "none"),
    (45, 1024, 4096, "bf16", "gelu"), (4, 1024, 51865, "logits", "none"),
    (45, 1024, 51865, "logits", "none"), (3000, 1024, 1024, "bf16", "none"),
]


@pytest.mark.parametrize("case", FAMILY_CASES, ids=str)
def test_family_projections_match_plain(cuda_device, case):
    """K1 (with the activation fused), K4 and K5 at each shape, each on
    its tensor-core design, against its plain version: bf16 outputs within
    2e-2, the fp32 logits (fp32 activations x the bf16 table read
    transposed, or ``unembed.w`` read row-major) within 1e-4 plus what the
    tensor cores' fp32 accumulation may drop over k (chip_smoke's
    ``tc_sum_allowance``: one ulp of the running sum on each of the
    3 * ceil(k / 16) steps)."""
    m, k, n, form, activation = case
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a, b = _schedule_operands(gen, m, k, n, "bf16" if form == "untied" else form)
    if form == "untied":
        a = _rand(gen, m, k, dtype=torch.float32, scale=4.0)
        b = _rand(gen, k, n, scale=0.02)
    design = ("wgmma-swapab-3xbf16" if a.dtype == torch.float32
              else "wgmma-swapab" if m <= 64 else None)
    for fn, plain, kw in ((matmul_tiled, matmul_tiled_plain, dict(activation=activation)),
                          (matmul_mcast, matmul_mcast_plain, {}),
                          (matmul_unicast, matmul_unicast_plain, {})):
        got = fn(a, b, **kw)
        torch.cuda.synchronize()
        want = design or ("wgmma-cluster" if fn is matmul_mcast else "wgmma")
        assert fn.design == want, fn.__name__
        assert got.dtype == a.dtype and got.shape == (m, n)
        ref = plain(a, b, **kw).float().cpu()
        if got.dtype == torch.float32:
            allow = 1e-4 * (1 + ref.abs()) + 3 * -(-k // 16) * 2.0 ** -23 * (
                ref.abs() + ref.square().mean(dim=-1, keepdim=True).sqrt())
            assert bool(((got.cpu() - ref).abs() <= allow).all()), fn.__name__
        else:
            close(got.cpu(), ref)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("m", [4, 300])
def test_tiled_out_dtype_and_no_bias(cuda_device, out_dtype, m):
    """K1's tensor-core designs store bf16 or fp32 whatever A's dtype, with
    and without a bias (fp32 out at M > 64 is grad(linear)'s z recompute);
    fp32 outputs within 1e-4, the tensor cores summing in their own fp32
    order."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    a, b = _rand(gen, m, 1024), _rand(gen, 1024, 2816, scale=1024 ** -0.5)
    for bias in (None, _rand(gen, 2816, dtype=torch.float32)):
        got = matmul_tiled(a, b, bias, activation="gelu", out_dtype=out_dtype)
        want = matmul_tiled_plain(a, b, bias, activation="gelu", out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert matmul_tiled.design == ("wgmma-swapab" if m <= 64 else "wgmma")
        assert got.dtype == out_dtype
        if out_dtype == torch.float32:  # chip_smoke's TOL_FP32, as for the logits
            torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-4)
        else:
            close(got.cpu(), want.float().cpu())


@pytest.mark.parametrize("name", ["matmul_tiled", "matmul_mcast"])
def test_split_k_is_deterministic_and_leaves_its_counters_at_zero(cuda_device, name):
    """K1 (with bias and silu) and K4 split K at 4 x 2816 x 1024 (16 column
    tiles) as K5 does: two launches give the same bits, and each kernel's
    own tile counters are back at 0."""
    from repro_torch.kernels.matmul import matmul as mm

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    a, b = _rand(gen, 4, 2816), _rand(gen, 2816, 1024, scale=2816 ** -0.5)
    bias = _rand(gen, 1024)
    fn = kernels.KERNELS[name]
    run = (lambda: fn(a, b, bias, activation="silu")) if name == "matmul_tiled" \
        else (lambda: fn(a, b))
    first, second = run(), run()
    torch.cuda.synchronize()
    assert fn.design == "wgmma-swapab"
    assert torch.equal(first, second)
    counters = mm._TILED_COUNTERS if name == "matmul_tiled" else mm._MCAST_COUNTERS
    assert int(counters[a.device].abs().sum()) == 0


@pytest.mark.parametrize("m,cluster", [(129, 2), (256, 2), (300, 4), (2049, 4)])
def test_mcast_cluster_size_and_idle_ctas(cuda_device, m, cluster):
    """K4's wgmma-cluster takes CL from its C rule (kernel_blocks reports
    CL x 128 rows); rows past M in the last cluster (129: one row of the
    second block; 300 and 2049: whole idle CTAs) are neither stored nor
    disturb the rest: two launches agree bit for bit with each other."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul import kernel_blocks

    assert _build.load("matmul_mcast").matmul_mcast_cluster(m) == cluster
    assert _build.load("matmul_mcast").matmul_mcast_active_clusters(m) > 0
    assert kernel_blocks(m)["mcast"]["bm"] == 128 * cluster
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    a, b = _rand(gen, m, 1024), _rand(gen, 1024, 1024, scale=1024 ** -0.5)
    first, second = matmul_mcast(a, b), matmul_mcast(a, b)
    torch.cuda.synchronize()
    assert matmul_mcast.design == "wgmma-cluster"
    assert torch.equal(first, second)
    close(first.cpu(), matmul_mcast_plain(a, b).float().cpu())


# (g, m, k, n, form, (K1's, K4's, K5's design)) of the grouped forms: the
# moonshot-v1-16b-a3b expert matmuls at decode (64 experts x 24 rows: 4
# sequences x top-6) and at a 512-token prefill (capacity 60), a split-K
# shape over 3 groups (splits = ceil(132 / 3) = 44: each group's column
# tile its own counter and workspace), M > 64 with idle cluster CTAs in
# every group (300 rows: CL 4, 3 row blocks), ragged M and N, an N whose
# rows TMA cannot read (cuda-core), fp32 A (3xbf16) and an A read
# through its strides ("x.t": a (m, g, k) tensor transposed, so a group's
# rows lie g * k apart and the groups k apart)
GROUPED_CASES = [
    (64, 24, 2048, 1408, "bf16", ("wgmma-swapab",) * 3),
    (64, 24, 1408, 2048, "bf16", ("wgmma-swapab",) * 3),
    (64, 60, 2048, 1408, "bf16", ("wgmma-swapab",) * 3),
    (3, 5, 4096, 64, "bf16", ("wgmma-swapab",) * 3),
    (4, 300, 256, 200, "bf16", ("wgmma", "wgmma-cluster", "wgmma")),
    (3, 130, 192, 136, "bf16", ("wgmma", "wgmma-cluster", "wgmma")),
    (3, 70, 100, 77, "bf16", ("cuda-core",) * 3),
    (2, 4, 1024, 320, "fp32 a", ("wgmma-swapab-3xbf16",) * 3),
    (5, 12, 256, 128, "x.t", ("wgmma-swapab",) * 3),
]


def _grouped_operands(gen, g, m, k, n, form):
    if form == "x.t":  # rows of a group g * k apart: A read through its strides
        a = _rand(gen, m, g, k).transpose(0, 1)
    else:
        a = _rand(gen, g, m, k, dtype=torch.float32 if form == "fp32 a" else torch.bfloat16)
    return a, _rand(gen, g, k, n, scale=k ** -0.5)


@pytest.mark.parametrize("case", GROUPED_CASES, ids=str)
@pytest.mark.parametrize("name", ["matmul_tiled", "matmul_mcast", "matmul_unicast"])
def test_grouped_kernels_match_plain(cuda_device, name, case):
    """K1 (silu, a bias per group), K4 and K5 over a stack of G groups in
    one launch: the design of the C rule, every group against the plain
    version's per-group product (bf16 within 2e-2, fp32 within 1e-4)."""
    g, m, k, n, form, designs = case
    gen = torch.Generator(device=cuda_device).manual_seed(g * m + k + n)
    a, b = _grouped_operands(gen, g, m, k, n, form)
    fn = kernels.KERNELS[name]
    if name == "matmul_tiled":
        bias = _rand(gen, g, n)
        run = lambda: fn(a, b, bias, activation="silu")  # noqa: E731
        want = matmul_tiled_plain(a, b, bias, activation="silu")
    else:
        run = lambda: fn(a, b)  # noqa: E731
        want = matmul_mcast_plain(a, b)
    before = fn.launches
    got = run()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.design == designs[("matmul_tiled", "matmul_mcast", "matmul_unicast").index(name)]
    assert got.shape == (g, m, n) and got.dtype == a.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want.float().cpu(), rtol=1e-4, atol=1e-4)
    else:
        close(got.cpu(), want.float().cpu())


@pytest.mark.parametrize("name", ["matmul_tiled", "matmul_mcast", "matmul_unicast"])
def test_grouped_split_k_keeps_groups_apart_and_counters_at_zero(cuda_device, name):
    """Split K over 3 groups (3 x 5 x 4096 x 64: 44 splits of one column
    tile each): two launches give the same bits, every counter is back at
    0, and a group whose A is zero comes out zero (K1: silu(bias)) while
    the others keep their values — no partial crosses into another
    group."""
    from repro_torch.kernels.matmul import matmul as mm

    gen = torch.Generator(device=cuda_device).manual_seed(44)
    a, b = _grouped_operands(gen, 3, 5, 4096, 64, "bf16")
    a[1] = 0
    assert mm._splits(name, 64, 4096, 3) == 44
    fn = kernels.KERNELS[name]
    bias = _rand(gen, 64)
    run = (lambda: fn(a, b, bias, activation="silu")) if name == "matmul_tiled" \
        else (lambda: fn(a, b))
    first, second = run(), run()
    torch.cuda.synchronize()
    assert fn.design == "wgmma-swapab"
    assert torch.equal(first, second)
    counters = {"matmul_tiled": mm._TILED_COUNTERS, "matmul_mcast": mm._MCAST_COUNTERS,
                "matmul_unicast": mm._UNICAST_COUNTERS}[name]
    assert int(counters[a.device].abs().sum()) == 0
    zero = ACTIVATIONS["silu"](bias.float()).to(a.dtype) if name == "matmul_tiled" \
        else torch.zeros_like(first[1])
    assert torch.equal(first[1], zero.expand_as(first[1]))
    for grp in (0, 2):
        one = fn(a[grp], b[grp], bias, activation="silu") if name == "matmul_tiled" \
            else fn(a[grp], b[grp])
        close(first[grp].cpu(), one.float().cpu())


@pytest.mark.parametrize("policy", ["tiled", "mcast", "unicast"])
def test_grouped_linear_lead_axes_on_the_card(cuda_device, policy):
    """``kernels.grouped_linear`` with two lead axes launches its schedule's
    kernel once for all groups and agrees with the plain versions' per-group
    products (its lead axes moved behind the group axis, as JAX's does)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, w = _rand(gen, 2, 3, 8, 6, 256), _rand(gen, 8, 256, 192, scale=256 ** -0.5)
    wrapper = kernels.KERNELS[f"matmul_{policy}"]
    before = wrapper.launches
    with kernels.use_policy(policy):
        got = kernels.grouped_linear(x, w, activation="silu")
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.shape == (2, 3, 8, 6, 192)
    want = torch.stack([matmul_tiled_plain(x.reshape(6, 8, 6, 256)[:, e].reshape(36, 256),
                                           w[e], activation="silu").reshape(2, 3, 6, 192)
                        for e in range(8)], dim=2)
    if policy != "tiled":  # K4 / K5 round the product, then silu in fp32 (JAX's _mm_flat)
        want = torch.stack([ACTIVATIONS["silu"](matmul_mcast_plain(
            x.reshape(6, 8, 6, 256)[:, e].reshape(36, 256), w[e]).float()).to(x.dtype)
            .reshape(2, 3, 6, 192) for e in range(8)], dim=2)
    close(got.cpu(), want.float().cpu())


@pytest.mark.parametrize("kvh", [16, 4, 1])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernels_match_plain(cuda_device, kvh, d):
    gen = torch.Generator(device=cuda_device).manual_seed(kvh)
    b, h, ps, n = 4, 16, 16, 16
    kp = _rand(gen, kvh, 1 + b * n, ps, d)
    vp = _rand(gen, kvh, 1 + b * n, ps, d)
    table = torch.arange(1, 1 + b * n, device=cuda_device, dtype=torch.int32).reshape(b, n)
    table[3, 1:] = 0  # a 1-token sequence with a null-page tail
    lengths = torch.tensor([256, 37, 200, 1], device=cuda_device, dtype=torch.int32)
    q = _rand(gen, b, h, d)
    got = paged_attention_decode(q, kp, vp, table, lengths - 1, lengths, softcap=30.0)
    want = paged_attention_decode_plain(q, kp, vp, table, lengths - 1, lengths, softcap=30.0)
    torch.cuda.synchronize()
    close(got.cpu(), want.float().cpu())
    for s in (1, 5, 16):
        qs = _rand(gen, b, s, h, d)
        start = torch.clamp(lengths - s, min=0)
        got = paged_attention_prefill(qs, kp, vp, table, start, lengths)
        want = paged_attention_prefill_plain(qs, kp, vp, table, start, lengths)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        close(got.cpu(), want.float().cpu())


# the attention of the last model families on the paged path: command-r-35b
# (64 heads over 8 KV heads of 128: group 8) and pixtral-12b (32 over 8)
@pytest.mark.parametrize("h,kvh", [(64, 8), (32, 8)], ids=["group8", "group4"])
def test_paged_kernels_match_plain_at_wide_groups(cuda_device, h, kvh):
    """K2 (``split-kv``) and K3 (``wgmma``) at d 128, bf16 pools, each
    against its plain version: decode tokens at contexts 1-300, and suffix
    prefills of 1, 5 and 28 tokens (28 x 8 = 224 query rows of a KV head
    at group 8)."""
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    b, ps, d, n = 4, 16, 128, 19
    kp, vp, table, lengths = _paged_case(cuda_device, gen, b=b, kvh=kvh, ps=ps, d=d, n=n,
                                         lengths=(40, 300, 129, 1))
    q = _rand(gen, b, h, d)
    got = paged_attention_decode(q, kp, vp, table, lengths - 1, lengths)
    torch.cuda.synchronize()
    assert paged_attention_decode.design == "split-kv"
    close(got.cpu(), paged_attention_decode_plain(q, kp, vp, table, lengths - 1,
                                                  lengths).float().cpu())
    for s in (1, 5, 28):
        qs = _rand(gen, b, s, h, d)
        start = torch.clamp(lengths - s, min=0)
        got = paged_attention_prefill(qs, kp, vp, table, start, lengths)
        torch.cuda.synchronize()
        assert paged_attention_prefill.design == "wgmma"
        close(got.cpu(), paged_attention_prefill_plain(qs, kp, vp, table, start,
                                                       lengths).float().cpu())


def test_prefill_kernel_int8_pools(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    kvh, pages, ps, d = 4, 20, 16, 64
    kq = torch.randint(-127, 128, (kvh, pages, ps, d), device=cuda_device, generator=gen,
                       dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = _rand(gen, kvh, pages, ps, 1, scale=0.01).abs()
    vs = _rand(gen, kvh, pages, ps, 1, scale=0.01).abs()
    table = torch.arange(1, 17, device=cuda_device, dtype=torch.int32).reshape(2, 8)
    lengths = torch.tensor([100, 21], device=cuda_device, dtype=torch.int32)
    q = _rand(gen, 2, 16, 16, d)
    start = lengths - 16
    got = kernels.op("paged_attention")(q, kq, vq, table, start, lengths, ks, vs)
    want = paged_attention_prefill_plain(q, kq, vq, table, start, lengths,
                                         k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    close(got.cpu(), want.float().cpu())


def _paged_case(dev, gen, *, b, kvh, ps, d, n, lengths, dtype=torch.bfloat16, h=16):
    kp = _rand(gen, kvh, 1 + b * n, ps, d, dtype=dtype)
    vp = _rand(gen, kvh, 1 + b * n, ps, d, dtype=dtype)
    table = torch.arange(1, 1 + b * n, device=dev, dtype=torch.int32).reshape(b, n)
    lengths = torch.tensor(lengths, device=dev, dtype=torch.int32)
    return kp, vp, table, lengths


@pytest.mark.parametrize("dtype,decode,prefill", [
    (torch.bfloat16, "split-kv", "wgmma"), (torch.float32, "cuda-core", "cuda-core")], ids=str)
def test_paged_designs_by_dtype(cuda_device, dtype, decode, prefill):
    """K2 runs split-kv and K3 wgmma on bf16 pools (K3 on int8 pools too),
    both cuda-core on fp32 pools; each wrapper names its last design."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    kp, vp, table, lengths = _paged_case(cuda_device, gen, b=2, kvh=4, ps=16, d=64, n=8,
                                         lengths=[100, 9], dtype=dtype)
    q = _rand(gen, 2, 16, 64, dtype=dtype)
    paged_attention_decode(q, kp, vp, table, lengths - 1, lengths)
    assert paged_attention_decode.design == decode
    qs = _rand(gen, 2, 5, 16, 64, dtype=dtype)
    paged_attention_prefill(qs, kp, vp, table, lengths - 5, lengths)
    assert paged_attention_prefill.design == prefill
    if dtype == torch.bfloat16:
        kq = torch.randint(-127, 128, kp.shape, device=cuda_device, generator=gen,
                           dtype=torch.int8)
        sc = _rand(gen, *kp.shape[:3], 1, scale=0.01).abs()
        paged_attention_prefill(qs, kq, kq, table, lengths - 5, lengths, k_scale=sc,
                                v_scale=sc)
        assert paged_attention_prefill.design == "wgmma"


def test_paged_split_kv_is_deterministic_and_leaves_its_counters_at_zero(cuda_device):
    """Two launches in a row give the same bits (each merges its splits in
    order and the last CTA of each group resets its counter)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa

    gen = torch.Generator(device=cuda_device).manual_seed(12)
    kp, vp, table, lengths = _paged_case(cuda_device, gen, b=4, kvh=16, ps=16, d=64, n=16,
                                         lengths=[256, 200, 37, 129])
    q = _rand(gen, 4, 16, 64)
    first = paged_attention_decode(q, kp, vp, table, lengths - 1, lengths)
    second = paged_attention_decode(q, kp, vp, table, lengths - 1, lengths)
    qs = _rand(gen, 4, 16, 16, 64)
    p1 = paged_attention_prefill(qs, kp, vp, table, lengths - 16, lengths)
    p2 = paged_attention_prefill(qs, kp, vp, table, lengths - 16, lengths)
    torch.cuda.synchronize()
    assert pa._decode_splits(1, 4, 16, 16, 64, 16) > 1
    assert pa._prefill_splits(1, 1, 4, 16, 16, 16, 16, 16, 64, 16) > 1
    assert torch.equal(first, second) and torch.equal(p1, p2)
    for name in ("paged_attention_decode", "paged_attention_prefill"):
        assert int(pa._COUNTERS[(name, q.device)].abs().sum()) == 0


@pytest.mark.parametrize("lengths", [(4096, 3584, 2048, 1024, 4096, 777, 3000, 1),
                                     (1, 4096, 1, 4096)], ids=str)
def test_paged_decode_long_contexts_split_over_ctas(cuda_device, lengths):
    """Contexts up to 4K, split over CTAs, and a batch mixing 1-token and
    4K-token sequences, against the plain version."""
    from repro_torch.kernels.paged_attention import paged_attention as pa

    gen = torch.Generator(device=cuda_device).manual_seed(len(lengths))
    b, n = len(lengths), 256
    kp, vp, table, lens = _paged_case(cuda_device, gen, b=b, kvh=16, ps=16, d=64, n=n,
                                      lengths=lengths)
    q = _rand(gen, b, 16, 64)
    assert pa._decode_splits(1, b, 16, 16, 64, n) > 1
    got = paged_attention_decode(q, kp, vp, table, lens - 1, lens)
    want = paged_attention_decode_plain(q, kp, vp, table, lens - 1, lens)
    torch.cuda.synchronize()
    assert paged_attention_decode.design == "split-kv"
    close(got.cpu(), want.float().cpu())


def test_paged_prefill_long_chunk(cuda_device):
    """The last 512-token chunk of a 2,048-token prompt: eight 64-row CTAs
    per kv head, against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    kp, vp, table, lengths = _paged_case(cuda_device, gen, b=1, kvh=16, ps=16, d=64, n=128,
                                         lengths=[2048])
    q = _rand(gen, 1, 512, 16, 64)
    got = paged_attention_prefill(q, kp, vp, table, lengths - 512, lengths)
    want = paged_attention_prefill_plain(q, kp, vp, table, lengths - 512, lengths)
    torch.cuda.synchronize()
    assert paged_attention_prefill.design == "wgmma"
    close(got.cpu(), want.float().cpu())


def test_engine_on_card_launches_every_kernel(cuda_device):
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = lm.init(cfg, seed=0)
    eng = PagedEngine(cfg, params, max_batch=2, cache_len=64, page_size=8)
    prefix = list(range(5, 30))
    kernels.reset_launch_counts()
    done = eng.run([Request(rid=i, prompt=prefix + [100 + i], max_new=4) for i in range(3)])
    eng.check()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    counts = kernels.launch_counts()
    paged = ("matmul_tiled", "paged_attention_decode", "paged_attention_prefill")
    assert all(counts[n] > 0 for n in paged), counts
    assert counts["matmul_mcast"] == counts["matmul_unicast"] == 0, counts


@pytest.mark.parametrize("policy,kernel", [
    (None, "matmul_tiled"), ("mcast", "matmul_mcast"), ("unicast", "matmul_unicast")])
def test_dense_server_on_card_launches_its_policys_kernel(cuda_device, policy, kernel):
    """The dense server drains under each policy, every projection through
    that policy's kernel and no other matmul kernel."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = lm.init(cfg, seed=0)
    server = Server(cfg, params, max_batch=2, cache_len=64)
    reqs = [Request(rid=i, prompt=list(range(3, 20 + i)), max_new=4) for i in range(3)]
    kernels.reset_launch_counts()
    with kernels.use_policy(policy):
        done = server.run(reqs)
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    counts = kernels.launch_counts()
    assert counts[kernel] > 0, counts
    assert sum(counts.values()) == counts[kernel], counts


# ---------------------------------------------------------------------------
# K6, K7, K8: flash attention and its gradient
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.flash_attention import _mask  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
)

# (b, h, kvh, sq, sk, d, causal, window, softcap): every head-dim tile
# (32, 64, 128, 256), GQA and MQA, ragged edges, sq != sk both ways, and
# rows that see no key (sq > sk + window - 1)
FLASH_CASES = [
    (1, 4, 4, 64, 64, 16, True, None, None),
    (2, 4, 2, 100, 100, 64, True, None, None),
    (1, 4, 1, 96, 160, 64, False, 24, None),
    (2, 8, 2, 130, 70, 128, True, 16, None),
    (1, 4, 2, 200, 77, 128, True, 16, 30.0),
    (1, 2, 1, 150, 150, 256, True, 40, 50.0),
    (1, 2, 2, 33, 300, 256, False, None, 8.0),
]


def _flash_close(got, want, tol):
    """|got - want| <= tol * (|want| + the RMS of want's row): attention
    averages are small where a row sees many keys, so the absolute term
    follows the row (the last axis) rather than a fixed floor."""
    g, w = got.float(), want.float()
    allow = tol * (w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt())
    diff = (g - w).abs()
    assert torch.isfinite(g).all(), "non-finite output"
    assert (diff <= allow).all(), f"worst err / allowance {float((diff / allow).max()):.3g}"


def _flash_inputs(gen, b, h, kvh, sq, sk, d, dtype):
    q = _rand(gen, b, h, sq, d, dtype=dtype)
    k = _rand(gen, b, kvh, sk, d, dtype=dtype)
    v = _rand(gen, b, kvh, sk, d, dtype=dtype)
    do = _rand(gen, b, h, sq, d, dtype=dtype)
    return q, k, v, do


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_kernels_match_plain(cuda_device, case, dtype):
    """K6, K7 and K8 each against its plain version on the same inputs
    (fp32: 1e-4 of the element and of its row's RMS, the reordered sums;
    bf16: 2e-2 of each, two ulps)."""
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq * sk + d)
    q, k, v, do = _flash_inputs(gen, b, h, kvh, sq, sk, d, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = kernels.launch_counts()
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    o_p, lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    _flash_close(o, o_p, tol)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq_p = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.dtype == dtype
    # bf16 dQ: the tensor-core K7 sums a single-key row's dP in its own
    # order, so those rows are held to their rounding bound (_dq_close)
    if dtype == torch.bfloat16:
        _dq_close(dq, dq_p, q, k, v, do, causal, window, tol)
    else:
        _flash_close(dq, dq_p, tol)
    _flash_close(dk, dk_p, tol)
    _flash_close(dv, dv_p, tol)
    after = kernels.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1, name


# bf16 cases of K6's, K7's and K8's wgmma design: every compile-time head
# dim (d 32 and 72 on zero-filled columns), sq and sk off the 128-row
# query and key tiles and the 32-128-row ring tiles, GQA groups 1, 2 and
# 8, softcap, window, rows that see no key (sq > sk + window - 1), and one
# head of 128 whose row 0 sees one key
WGMMA_CASES = [
    (1, 1, 1, 128, 128, 64, True, None, None),
    (1, 8, 8, 200, 200, 32, True, None, None),
    (2, 8, 4, 130, 333, 64, False, None, None),
    (1, 16, 2, 257, 250, 64, True, 100, 20.0),
    (1, 8, 1, 300, 77, 128, True, 16, None),
    (2, 4, 2, 190, 190, 128, True, None, 30.0),
    (1, 4, 2, 100, 100, 72, True, None, None),
    (1, 4, 4, 150, 260, 256, True, 40, 50.0),
    (1, 16, 2, 33, 300, 256, False, None, None),
]


def _dq_close(dq, dq_p, q, k, v, do, causal, window, tol=2e-2):
    """dQ against the plain version under the row-RMS allowance of tol,
    except on rows that see exactly one key: there p = 1 and dS = dP -
    delta, two fp32 sums of the same d exact products, so dQ is 0 in
    exact arithmetic and each side returns its own rounding of it (the
    plain version's row may be exactly 0, where that allowance has no
    width).  Those rows are held to the bound of that rounding: each sum
    errs by at most d 2^-24 times the sum of its terms' magnitudes."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    mask = _mask(sq, k.shape[2], causal, window, q.device)
    one = mask.sum(dim=-1) == 1
    _flash_close(dq[:, :, ~one], dq_p[:, :, ~one], tol)
    key = mask.float().argmax(dim=-1)[one]
    kc = k.repeat_interleave(group, dim=1).float()[:, :, key]
    vc = v.repeat_interleave(group, dim=1).float()[:, :, key]
    terms = (do.float()[:, :, one].abs() * vc.abs()).sum(dim=-1, keepdim=True)
    bound = 2 * d * 2.0**-24 * terms * kc.abs() / math.sqrt(d) * 1.01
    for t in (dq, dq_p):
        assert (t[:, :, one].float().abs() <= bound).all()


@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_flash_wgmma_design_matches_plain(cuda_device, case):
    """K6, K7 and K8 on bf16 with d % 8 == 0 run on the tensor cores
    (wgmma fed by TMA) and agree with their plain versions within 2e-2 of
    the element and of its row's RMS (dQ's single-key rows: the rounding
    bound of _dq_close; no case has a key fed only by such rows)."""
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq * 7 + sk + d)
    q, k, v, do = _flash_inputs(gen, b, h, kvh, sq, sk, d, torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert flash_attention.design == "wgmma"
    o_p, lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    _flash_close(o, o_p, 2e-2)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    delta = (do.float() * o_p.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    assert flash_attention_bwd_dq.design == "wgmma"
    dq_p = flash_attention_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    assert flash_attention_bwd_dkv.design == "wgmma"
    dk_p, dv_p = flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    _dq_close(dq, dq_p, q, k, v, do, causal, window)
    _flash_close(dk, dk_p, 2e-2)
    _flash_close(dv, dv_p, 2e-2)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 20)], ids=str)
def test_flash_cuda_core_design_runs_fp32_and_unaligned_rows(cuda_device, dtype, d):
    """fp32 operands, and bf16 rows of a length that is not a multiple of
    16 bytes (d % 8 != 0, which TMA cannot read), run the CUDA-core K6,
    K7 and K8: the C entries' fixed rule, not a fallback."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, do = _flash_inputs(gen, 2, 4, 2, 100, 90, d, dtype)
    kw = dict(causal=True, window=None, softcap=None)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert flash_attention.design == "cuda-core"
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    assert flash_attention_bwd_dq.design == "cuda-core"
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert flash_attention_bwd_dkv.design == "cuda-core"
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    o_p = flash_attention_plain(q, k, v, **kw)
    dq_p = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dk_p, dv_p = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    _flash_close(o, o_p, tol)
    _flash_close(dk, dk_p, tol)
    _flash_close(dv, dv_p, tol)
    if dtype == torch.float32:
        _flash_close(dq, dq_p, tol)
    else:
        _dq_close(dq, dq_p, q, k, v, do, True, None)


def test_flash_wgmma_design_rejects_a_misaligned_base(cuda_device):
    """TMA reads 16-byte-aligned tensors: a contiguous bf16 operand whose
    base is 2 bytes off makes the C entry return an error, and the
    wrapper raises; nothing launches and nothing falls back."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, do = _flash_inputs(gen, 1, 4, 2, 64, 64, 64, torch.bfloat16)
    lse = torch.zeros(1, 4, 64, device=cuda_device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="cudaError"):
        flash_attention(shifted(q), k, v)
    with pytest.raises(RuntimeError, match="cudaError"):
        flash_attention_bwd_dq(q, shifted(k), v, do, lse, lse)
    with pytest.raises(RuntimeError, match="cudaError"):
        flash_attention_bwd_dkv(q, k, v, shifted(do), lse, lse)
    assert kernels.launch_counts() == before


def test_flash_keyless_rows_average_v(cuda_device):
    """A row that sees no key returns the mean of V with lse = NEG_INF."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = _rand(gen, 1, 1, 8, 4, dtype=torch.float32)
    k = _rand(gen, 1, 1, 2, 4, dtype=torch.float32)
    v = _rand(gen, 1, 1, 2, 4, dtype=torch.float32)
    o, lse = flash_attention(q, k, v, causal=True, window=2, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o[0, 0, 3:], v.mean(dim=2)[0].expand(5, 4), rtol=1e-6, atol=1e-6)
    assert (lse[0, 0, 3:] == -(2.0**30)).all()


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[7] is None or c[3] < c[4] + c[7]],
                         ids=str)
def test_flash_function_matches_autograd_through_attention_ref(cuda_device, case):
    """The autograd function (K6 forward, K7 + K8 backward, GQA group
    sum) against PyTorch's autograd through the oracle, fp32, on cases
    where every row sees a key (a keyless row's kernel gradient uses
    p = 1, as the JAX kernels do, not the oracle's softmax)."""
    b, h, kvh, sq, sk, d, causal, window, softcap = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq + sk)
    q, k, v, _ = _flash_inputs(gen, b, h, kvh, sq, sk, d, torch.float32)
    w = _rand(gen, b, h, sq, d, dtype=torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    grads = []
    for fn in (kernels.op("flash_attention"), attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, **kw)
        grads.append((out, *torch.autograd.grad((out * w).sum(), leaves)))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_op_runs_where_the_tpu_blocks_do_not_fit(cuda_device):
    """s = 1400 at d = 256 in fp32: no TPU block divides it and one
    whole-sequence block overflows the JAX package's VMEM budget; the
    CUDA tiles mask the ragged edge, so dispatch launches K6 all the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v, _ = _flash_inputs(gen, 1, 2, 1, 1400, 1400, 256, torch.float32)
    kernels.reset_launch_counts()
    out = kernels.op("flash_attention")(q, k, v)
    assert kernels.launch_counts()["flash_attention"] == 1
    _flash_close(out, flash_attention_plain(q, k, v), 1e-4)


def test_flash_autograd_launches_each_kernel_once(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, _ = _flash_inputs(gen, 2, 4, 2, 64, 64, 64, torch.bfloat16)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    out = kernels.op("flash_attention")(*leaves)
    assert kernels.launch_counts()["flash_attention"] == 1
    torch.autograd.grad(out.float().sum(), leaves)
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 1, counts
    assert sum(counts.values()) == 3, counts


@pytest.mark.parametrize("policy", ["tiled", "mcast", "unicast"])
def test_linear_grad_on_card_matches_plain(cuda_device, policy):
    """grad(linear): one forward launch, then z, dA and dB — each a
    kernel launch — against the same graph on the plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    a, b = _rand(gen, 96, 200), _rand(gen, 200, 72, scale=200 ** -0.5)
    bias = _rand(gen, 72)
    w = _rand(gen, 96, 72, dtype=torch.float32)
    kernels.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (a, b, bias)]
    y = kernels.linear(leaves[0], leaves[1], bias=leaves[2], activation="silu", policy=policy)
    assert sum(kernels.launch_counts().values()) == 1
    got = torch.autograd.grad((y.float() * w).sum(), leaves)
    assert sum(kernels.launch_counts().values()) == 4
    cpu = [t.detach().cpu().requires_grad_() for t in (a, b, bias)]
    y = kernels.linear(cpu[0], cpu[1], bias=cpu[2], activation="silu", policy=policy)
    want = torch.autograd.grad((y.float() * w.cpu()).sum(), cpu)
    for g, ww in zip(got, want):
        close(g.cpu(), ww.float())


@pytest.mark.parametrize("policy,forward", [
    ("tiled", "wgmma"), ("mcast", "wgmma-cluster"), ("unicast", "wgmma")])
def test_linear_grad_backward_runs_k1_wgmma(cuda_device, policy, forward):
    """grad(linear) at 1024 x 512 x 768: the forward on its policy's
    tensor-core design, then z (fp32 out), dA (B = b.t(), K-major) and dB
    (A = a.t(), M-major) each on K1's wgmma design."""
    from unittest import mock

    from repro_torch.kernels import api

    designs = []

    def noting(*args, **kw):
        out = matmul_tiled(*args, **kw)
        designs.append(matmul_tiled.design)
        return out

    gen = torch.Generator(device=cuda_device).manual_seed(12)
    a, b = _rand(gen, 1024, 512), _rand(gen, 512, 768, scale=512 ** -0.5)
    bias = _rand(gen, 768)
    w = _rand(gen, 1024, 768, dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (a, b, bias)]
    kernels.reset_launch_counts()
    y = kernels.linear(leaves[0], leaves[1], bias=leaves[2], activation="silu", policy=policy)
    assert kernels.KERNELS[{"tiled": "matmul_tiled", "mcast": "matmul_mcast",
                            "unicast": "matmul_unicast"}[policy]].design == forward
    with mock.patch.object(api, "matmul_tiled", noting):
        got = torch.autograd.grad((y.float() * w).sum(), leaves)
    assert designs == ["wgmma"] * 3
    assert sum(kernels.launch_counts().values()) == 4
    cpu = [t.detach().cpu().requires_grad_() for t in (a, b, bias)]
    y = kernels.linear(cpu[0], cpu[1], bias=cpu[2], activation="silu", policy=policy)
    want = torch.autograd.grad((y.float() * w.cpu()).sum(), cpu)
    for g, ww in zip(got, want):
        close(g.cpu(), ww.float())


def test_flash_kernels_reject_bad_inputs(cuda_device):
    q = torch.zeros(1, 4, 8, 16, device=cuda_device)
    kv = torch.zeros(1, 2, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros(1, 3, 8, 16, device=cuda_device),
                        torch.zeros(1, 3, 8, 16, device=cuda_device))
    with pytest.raises(TypeError):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), kv.transpose(2, 3), kv.transpose(2, 3))
    lse = torch.zeros(1, 4, 8, device=cuda_device)
    with pytest.raises(TypeError, match="fp32"):
        flash_attention_bwd_dq(q, kv, kv, q, lse.bfloat16(), lse)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd_dkv(q, kv, kv, q, lse[:, :, :4], lse)


# ---------------------------------------------------------------------------
# K9, K10, K11, K12: the scans and their adjoints
# ---------------------------------------------------------------------------

from repro_torch.kernels.rglru import (  # noqa: E402
    rglru_scan,
    rglru_scan_bwd,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
    rglru_scan_ref,
)
from repro_torch.kernels.ssd import (  # noqa: E402
    ssd_lcum,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
)


def _ssd_inputs(gen, b, h, s, p, n):
    xdt = _rand(gen, b, h, s, p, dtype=torch.float32, scale=0.5)
    bm = _rand(gen, b, s, n, dtype=torch.float32, scale=0.5)
    cm = _rand(gen, b, s, n, dtype=torch.float32, scale=0.5)
    log_a = -torch.nn.functional.softplus(_rand(gen, b, h, s, dtype=torch.float32))
    return xdt, bm, cm, log_a, _rand(gen, b, h, s, p, dtype=torch.float32)


def _lru_inputs(gen, b, s, d, slow_decay=False):
    """a = 0.8 + 0.2 sigmoid(N(0, 1)), or with ``slow_decay`` exp of a
    uniform in [-0.1, -1e-4] (chip_smoke's draws); b, dh ~ N(0, 1)."""
    if slow_decay:
        a = torch.exp(-1e-4 - (0.1 - 1e-4) * torch.rand(b, s, d, device=gen.device,
                                                         generator=gen))
    else:
        a = 0.8 + 0.2 * torch.sigmoid(_rand(gen, b, s, d, dtype=torch.float32))
    return a, _rand(gen, b, s, d, dtype=torch.float32), _rand(gen, b, s, d, dtype=torch.float32)


def _lru_fp64(a, x, h_prev, dh):
    """The RG-LRU recurrence and its adjoint in fp64, one step at a time:
    h from (a, x), and (da, db) from (a, h_prev, dh)."""
    a, x, h_prev, dh = (t.double() for t in (a, x, h_prev, dh))
    h, da, db = torch.empty_like(a), torch.empty_like(a), torch.empty_like(a)
    state, carry = torch.zeros_like(a[:, 0]), torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        state = a[:, t] * state + x[:, t]
        h[:, t] = state
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + carry
        da[:, t], db[:, t] = g * h_prev[:, t], g
        carry = a[:, t] * g
    return h, da, db


def _ssd_fp64(xdt, bm, cm, lcum, dy, chunk=64):
    """The recurrence in fp64, one step at a time, on the per-step
    log-decays that ``lcum`` encodes (its differences inside each chunk),
    and its gradients by autograd: y, the chunk-initial states, dxdt, dB
    and dC per head (each head reads its own copy of B and C), d log a."""
    bsz, h, s, p = xdt.shape
    lc = lcum[..., 0].double()
    la = torch.cat([lc[..., :1], lc[..., 1:] - lc[..., :-1]], dim=-1)
    la[..., ::chunk] = lc[..., ::chunk]
    x, la = xdt.double().requires_grad_(), la.requires_grad_()
    b_h, c_h = (m.double()[:, None].expand(bsz, h, s, m.shape[-1]).clone().requires_grad_()
                for m in (bm, cm))
    state, ys, states = x.new_zeros(bsz, h, p, bm.shape[-1]), [], []
    for t in range(s):
        if t % chunk == 0:
            states.append(state)
        state = torch.exp(la[:, :, t])[..., None, None] * state \
            + x[:, :, t, :, None] * b_h[:, :, t, None, :]
        ys.append((state * c_h[:, :, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=2)
    grads = torch.autograd.grad((y * dy.double()).sum(), (x, b_h, c_h, la))
    return (y.detach(), torch.stack(states, dim=2).detach(), *grads)


# the ragged cell (no chunk in 32..256 divides s = 200; P 32, N 16 under
# one tile) and a last chunk of one step
@pytest.mark.parametrize("shape", [(1, 3, 200, 32, 16), (2, 2, 65, 20, 40)], ids=str)
def test_ssd_kernels_match_plain(cuda_device, shape):
    """K9 (y and its checkpoints) and K10 (fed K9's states) against their
    plain versions: 1e-4 of the element and of its row's RMS (fp32 sums in
    another order; d log a's row is the sequence)."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    xdt, bm, cm, log_a, dy = _ssd_inputs(gen, *shape)
    lcum = ssd_lcum(log_a, 64)
    before = kernels.launch_counts()
    y, states = ssd_scan(xdt, bm, cm, lcum, return_states=True)
    y_p, states_p = ssd_scan_plain(xdt, bm, cm, lcum, return_states=True)
    torch.cuda.synchronize()
    _flash_close(y, y_p, 1e-4)
    _flash_close(states, states_p, 1e-4)
    _flash_close(ssd_scan(xdt, bm, cm, lcum), y_p, 1e-4)  # without return_states
    got = ssd_scan_bwd(xdt, bm, cm, lcum, states, dy)
    want = ssd_scan_bwd_plain(xdt, bm, cm, lcum, states, dy)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[:3]):
        _flash_close(g, w, 1e-4)
    _flash_close(got[3][..., 0], want[3][..., 0], 1e-4)
    after = kernels.launch_counts()
    assert after["ssd_scan"] == before["ssd_scan"] + 2
    assert after["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1


# test_ssd_kernels_match_plain's shapes and a 256 KB fp32 state
@pytest.mark.parametrize("shape", [(1, 3, 200, 32, 16), (1, 2, 256, 64, 1024),
                                   (2, 2, 65, 20, 40)], ids=str)
def test_ssd_kernels_match_fp64_recurrence(cuda_device, shape):
    """K9 (y and its checkpoints) and K10 (fed K9's states) against the
    recurrence evaluated in fp64, at the same 1e-4.  At the 256 KB
    state's first step, y_0 = (C_0 . B_0) xdt_0 with C_0 . B_0 cancelling
    to 1e-3 of its 1024 terms, and any fp32 sum of it moves y_0 by several
    allowances (the plain version 4.6, on an H100): there two correct
    fp32 sums disagree, and only the exact value decides."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    xdt, bm, cm, log_a, dy = _ssd_inputs(gen, *shape)
    lcum = ssd_lcum(log_a, 64)
    y, states = ssd_scan(xdt, bm, cm, lcum, return_states=True)
    want = _ssd_fp64(xdt, bm, cm, lcum, dy)
    torch.cuda.synchronize()
    _flash_close(y, want[0], 1e-4)
    _flash_close(states, want[1], 1e-4)
    got = ssd_scan_bwd(xdt, bm, cm, lcum, states, dy)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want[2:5]):
        _flash_close(g, w, 1e-4)
    _flash_close(got[3][..., 0], want[5], 1e-4)


def _ssd_against_plain(xdt, bm, cm, lcum, dy):
    """K9 (y, its checkpoints) and K10 (fed them) against their plain
    versions at chip_smoke's TOL_SCAN, 1e-4 x (|want| + row RMS), each
    on the chunk-parallel design; returns the kernels' outputs."""
    y, states = ssd_scan(xdt, bm, cm, lcum, return_states=True)
    y_p, states_p = ssd_scan_plain(xdt, bm, cm, lcum, return_states=True)
    got = ssd_scan_bwd(xdt, bm, cm, lcum, states, dy)
    want = ssd_scan_bwd_plain(xdt, bm, cm, lcum, states, dy)
    torch.cuda.synchronize()
    assert ssd_scan.design == ssd_scan_bwd.design == "chunk-parallel"
    _flash_close(y, y_p, 1e-4)
    _flash_close(states, states_p, 1e-4)
    for g, w in zip(got[:3], want[:3]):
        _flash_close(g, w, 1e-4)
    _flash_close(got[3][..., 0], want[3][..., 0], 1e-4)
    return (y, states, *got)


# the chunk-parallel design's edges: one chunk (s 40); a short last chunk
# (s 200); P 32 with N 48, not a multiple of the 32- or 64-column N tiles;
# b x h = 1; P 100, over two P tiles (K10 sums T over them and finishes
# dB, dC in place); P 7 and N 5, not multiples of 4 (4-byte copies)
@pytest.mark.parametrize("shape", [(1, 2, 40, 32, 48), (1, 3, 200, 32, 16),
                                   (2, 2, 130, 32, 48), (1, 1, 130, 32, 48),
                                   (1, 2, 130, 100, 24), (1, 2, 70, 7, 5)], ids=str)
def test_ssd_chunk_parallel_edges_match_plain(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    xdt, bm, cm, log_a, dy = _ssd_inputs(gen, *shape)
    _ssd_against_plain(xdt, bm, cm, ssd_lcum(log_a, 64), dy)


def test_ssd_kernels_repeat_to_the_bit_over_nan_filled_memory(cuda_device):
    """A second call on the same inputs returns the first call's bits,
    also after the caching allocator's free blocks (both pools) were
    filled with NaN: no kernel reads its scratch (states, adjoint states,
    scores) before writing it, and no sum depends on timing."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    xdt, bm, cm, log_a, dy = _ssd_inputs(gen, 1, 3, 200, 32, 48)
    lcum = ssd_lcum(log_a, 64)
    first = _ssd_against_plain(xdt, bm, cm, lcum, dy)
    junk = [torch.full((n,), float("nan"), device=cuda_device)
            for n in [1 << 12] * 256 + [1 << 16] * 64 + [1 << 24] * 4]
    del junk
    second = _ssd_against_plain(xdt, bm, cm, lcum, dy)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("where", ["xdt", "dy", "b", "c", "log_a"])
def test_ssd_kernels_carry_nan_where_the_plain_versions_do(cuda_device, where):
    """A NaN in one input of batch 0 — the card's own default NaN
    (0x7fffffff, what torch.log of a negative number gives here) and
    0xffffffff — makes every output the plain versions make non-finite
    non-finite in the kernels too, and no other: the TF32 split must pass
    NaN through.  Batch 1 stays finite and matches the plain versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    xdt, bm, cm, log_a, dy = _ssd_inputs(gen, 2, 2, 130, 32, 48)
    made = torch.log(-torch.ones(1, device=cuda_device))
    assert made.view(torch.int32).item() == 0x7FFFFFFF
    nans = torch.cat([made, torch.tensor([-1], dtype=torch.int32,
                                         device=cuda_device).view(torch.float32)])
    flat = dict(xdt=xdt, dy=dy, b=bm, c=cm, log_a=log_a)[where][0].view(-1)
    flat[[flat.numel() // 3, flat.numel() // 2]] = nans
    lcum = ssd_lcum(log_a, 64)
    y, states = ssd_scan(xdt, bm, cm, lcum, return_states=True)
    y_p, states_p = ssd_scan_plain(xdt, bm, cm, lcum, return_states=True)
    got = ssd_scan_bwd(xdt, bm, cm, lcum, states, dy)
    want = ssd_scan_bwd_plain(xdt, bm, cm, lcum, states_p, dy)
    torch.cuda.synchronize()
    outputs = {"y": (y, y_p), "states": (states, states_p), "dxdt": (got[0], want[0]),
               "dB": (got[1], want[1]), "dC": (got[2], want[2]),
               "dlog_a": (got[3][..., 0], want[3][..., 0])}  # its row is the sequence
    non_finite = {name: (not bool(torch.isfinite(g[0]).all()),
                         not bool(torch.isfinite(w[0]).all()))
                  for name, (g, w) in outputs.items()}
    assert all(k == p for k, p in non_finite.values()), non_finite
    reached = {"xdt": ("y", "dB"), "dy": ("dxdt", "dB", "dC")}.get(where, ("y", "dxdt"))
    assert all(non_finite[name][1] for name in reached), non_finite
    for g, w in outputs.values():
        _flash_close(g[1], w[1], 1e-4)


def _shifted_h(h):
    return torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))


# (b, s, d, slow decays) against the kernels' 64-step chunks and 64-channel
# tiles: two chunks, the last of 13 (chip_smoke's ragged cell); d = 7 in
# one chunk; the benchmark's width; s < 64; s = 1; s = 3 x 64 + 5; d = 7
# over three chunks (4-byte copies); slow decays (log a in [-0.1, -1e-4])
# whose carry outlives many chunks
LRU_CASES = [(3, 77, 192, False), (1, 5, 7, False), (2, 512, 512, False), (2, 40, 128, False),
             (2, 1, 64, False), (2, 197, 256, False), (2, 150, 7, False), (1, 2048, 256, True)]


@pytest.mark.parametrize("case", LRU_CASES, ids=str)
def test_rglru_kernels_match_plain_and_fp64_recurrence(cuda_device, case):
    """K11 and K12 (fed K11's h shifted one step) against their plain
    versions and against the recurrence in fp64, at chip_smoke's TOL_SCAN,
    1e-4 x (|want| + row RMS).  The chunked-lookback design composes the
    carry into a chunk from the chunks' aggregates where the chunk before
    has not published its own, so it agrees with the sequential walk to
    fp32 rounding, not to the bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(case))
    a, x, dh = _lru_inputs(gen, *case)
    h = rglru_scan(a, x)
    h_prev = _shifted_h(h)
    da, db = rglru_scan_bwd(a, h_prev, dh)
    torch.cuda.synchronize()
    assert rglru_scan.design == rglru_scan_bwd.design == "chunked-lookback"
    plain = (rglru_scan_plain(a, x), *rglru_scan_bwd_plain(a, h_prev, dh))
    for got, want, exact in zip((h, da, db), plain, _lru_fp64(a, x, h_prev, dh)):
        _flash_close(got, want, 1e-4)
        _flash_close(got, exact, 1e-4)


@pytest.mark.parametrize("where", ["b", "a", "dh"])
def test_rglru_kernels_carry_nan_where_the_plain_versions_do(cuda_device, where):
    """A NaN in b, a NaN in a or an inf in dh, at one element of batch 0
    in the second of four chunks, makes non-finite exactly the outputs,
    element by element, that the plain versions make non-finite: a
    non-finite aggregate or prefix must reach every later chunk (earlier,
    for K12) of its channel and no other.  K12 is fed the plain version's
    h_prev, so that its inputs are the plain version's."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    a, x, dh = _lru_inputs(gen, 2, 200, 96)
    dict(b=x, a=a, dh=dh)[where][0, 100, 5] = float("inf") if where == "dh" else float("nan")
    h, h_p = rglru_scan(a, x), rglru_scan_plain(a, x)
    h_prev = _shifted_h(h_p)
    got = (h, *rglru_scan_bwd(a, h_prev, dh))
    want = (h_p, *rglru_scan_bwd_plain(a, h_prev, dh))
    torch.cuda.synchronize()
    reached = {"b": (True, True, False), "a": (True, True, True), "dh": (False, True, True)}
    for g, w, hit in zip(got, want, reached[where]):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        assert bool((~torch.isfinite(w[0])).any()) == hit
        _flash_close(g[1], w[1], 1e-4)


def test_rglru_scratch_serves_calls_of_any_shape_in_turn(cuda_device):
    """The look-back flags and the ticket counter are kept between calls
    and tagged with each call's epoch: calls of several shapes in turn,
    repeated, each agree with the plain versions (a flag left by an
    earlier call must never read as published)."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    cases = [_lru_inputs(gen, *shape) for shape in ((2, 512, 512), (3, 77, 192), (1, 300, 40))]
    for _ in range(3):
        for a, x, dh in cases:
            h = rglru_scan(a, x)
            h_prev = _shifted_h(h)
            got = (h, *rglru_scan_bwd(a, h_prev, dh))
            want = (rglru_scan_plain(a, x), *rglru_scan_bwd_plain(a, h_prev, dh))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                _flash_close(g, w, 1e-4)


def test_scan_autograd_launches_each_kernel_once(cuda_device):
    """op("ssd") and op("rglru") under autograd: one forward launches K9
    (K11) once, one backward K10 (K12) once, and the gradients hold to
    autograd through the plain forward."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    cases = [("ssd", _ssd_inputs(gen, 1, 3, 130, 32, 16)[:4],
              lambda xdt, bm, cm, la: ssd_scan_plain(xdt, bm, cm, ssd_lcum(la, 64)),
              ("ssd_scan", "ssd_scan_bwd")),
             ("rglru", _lru_inputs(gen, 2, 50, 96)[:2], rglru_scan_ref,
              ("rglru_scan", "rglru_scan_bwd"))]
    for family, inputs, plain, (fwd_name, bwd_name) in cases:
        grads = []
        for fn in (kernels.op(family), plain):
            leaves = [t.clone().requires_grad_() for t in inputs]
            kernels.reset_launch_counts()
            out = fn(*leaves)
            fwd = kernels.launch_counts()
            w = torch.ones_like(out).cumsum(-1).sin()
            grads.append((out, *torch.autograd.grad((out * w).sum(), leaves)))
            total = kernels.launch_counts()
            if fn is not plain:
                assert fwd[fwd_name] == 1 and sum(fwd.values()) == 1, fwd
                assert total[bwd_name] == 1 and sum(total.values()) == 2, total
        torch.cuda.synchronize()
        for got, want in zip(*grads):
            _flash_close(got, want, 1e-4)


def test_scan_kernels_reject_bad_inputs(cuda_device):
    xdt, bc, lcum = (torch.zeros(1, 2, 64, 8, device=cuda_device),
                     torch.zeros(1, 64, 4, device=cuda_device),
                     torch.zeros(1, 2, 64, 1, device=cuda_device))
    states, a = torch.zeros(1, 2, 1, 8, 4, device=cuda_device), \
        torch.zeros(2, 16, 8, device=cuda_device)
    with pytest.raises(TypeError, match="fp32"):
        ssd_scan(xdt.bfloat16(), bc, bc, lcum)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xdt.transpose(2, 3).contiguous().transpose(2, 3), bc, bc, lcum)
    with pytest.raises(ValueError, match="should be"):
        ssd_scan(xdt, bc[:, :32], bc, lcum)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(xdt, bc, bc, lcum, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(xdt, bc.cpu(), bc, lcum)
    with pytest.raises(ValueError, match="states"):
        ssd_scan_bwd(xdt, bc, bc, lcum, states[:, :1], xdt)
    with pytest.raises(TypeError, match="fp32"):
        ssd_scan_bwd(xdt, bc, bc, lcum, states.half(), xdt)
    with pytest.raises(TypeError, match="fp32"):
        rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), a)
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_bwd(a, a, a[:, :8])


# ---------------------------------------------------------------------------
# the speculative int8 slice: qwen1.5-1.8b's operating points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 5], ids=["decode", "verify"])
def test_prefill_kernel_int8_pools_at_head_dim_128(cuda_device, s):
    """K3 on int8 pools at qwen1.5-1.8b's attention (16 heads of 128, page
    16): a decode token and a verify burst (s = k + 1 = 5) per sequence,
    contexts 40-300, against the plain version (bf16 tolerance)."""
    gen = torch.Generator(device=cuda_device).manual_seed(128 + s)
    b, h, kvh, ps, d, n = 4, 16, 16, 16, 128, 19
    shape = (kvh, 1 + b * n, ps, d)
    kq = torch.randint(-127, 128, shape, device=cuda_device, generator=gen, dtype=torch.int8)
    vq = torch.randint_like(kq, -127, 128)
    ks = _rand(gen, *shape[:3], 1, scale=0.01).abs()
    vs = _rand(gen, *shape[:3], 1, scale=0.08).abs()
    table = torch.arange(1, 1 + b * n, device=cuda_device, dtype=torch.int32).reshape(b, n)
    lengths = torch.tensor([40, 300, 129, 77], device=cuda_device, dtype=torch.int32)
    q = _rand(gen, b, s, h, d)
    start = lengths - s
    before = paged_attention_prefill.launches
    got = kernels.op("paged_attention")(q, kq, vq, table, start, lengths, ks, vs)
    want = paged_attention_prefill_plain(q, kq, vq, table, start, lengths,
                                         k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert paged_attention_prefill.launches == before + 1
    assert paged_attention_prefill.design == "wgmma"
    assert torch.isfinite(got.float()).all()
    close(got.cpu(), want.float().cpu())


@pytest.mark.parametrize("m", [4, 20], ids=["decode", "verify"])
def test_untied_logits_kernel_matches_plain(cuda_device, m):
    """K1 on qwen1.5-1.8b's untied head: fp32 activations times the bf16
    (d, vocab) head read row-major (N-major B, unlike the tied table's
    transposed view), at the decode and verify row counts; the 3xbf16
    design, within chip_smoke's TOL_FP32 of 1e-4."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    k, n = 2048, 151936
    a = _rand(gen, m, k, dtype=torch.float32, scale=4.0)
    w = _rand(gen, k, n, scale=0.02)
    got = kernels.linear(a, w)
    torch.cuda.synchronize()
    assert matmul_tiled.design == "wgmma-swapab-3xbf16"
    want = matmul_tiled_plain(a, w).cpu()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_engine_on_card_serves_int8_pools_with_a_model_draft(cuda_device):
    """The reduced qwen1.5-1.8b on int8 pools with its registered draft:
    every request drains, the pool audit holds, and int8 pools never
    reach K2 — every target step runs K3, every projection K1."""
    from repro_torch.configs.registry import draft_for
    from repro_torch.serve import ServeConfig

    tcfg = get_config("qwen1.5-1.8b", reduced=True)
    dcfg = get_config(draft_for("qwen1.5-1.8b"), reduced=True)
    eng = PagedEngine(tcfg, lm.init(tcfg, seed=0), draft=(dcfg, lm.init(dcfg, seed=0)),
                      config=ServeConfig(max_slots=2, cache_len=64, page_size=8,
                                         kv_dtype="int8", spec_k=4,
                                         draft_model="qwen1.5-0.5b"))
    prefix = list(range(5, 30))
    kernels.reset_launch_counts()
    done = eng.run([Request(rid=i, prompt=prefix + [100 + i], max_new=9) for i in range(3)])
    eng.check()
    assert len(done) == 3 and all(len(r.out) == 9 for r in done)
    counts = kernels.launch_counts()
    assert counts["matmul_tiled"] > 0 and counts["paged_attention_prefill"] > 0, counts
    assert counts["paged_attention_decode"] == 0, counts
    assert eng.stats()["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# the reference backend and the fallback on the card
# ---------------------------------------------------------------------------


def _reference_cases(gen):
    """One serving shape per family: (family, inputs, options, tolerance
    class) — qwen1.5-0.5b's decode gate projection and its attention
    (decode on bf16 pools, a 16-token chunk on int8 pools), its flash
    shape, mamba2's SSD layer and recurrentgemma's RG-LRU at short
    sequences."""
    from repro_torch.nn.kvquant import quantize_kv

    kp, vp = _rand(gen, 16, 33, 16, 64), _rand(gen, 16, 33, 16, 64)
    table = torch.arange(1, 33, device="cuda", dtype=torch.int32).reshape(4, 8)
    lengths = torch.tensor([100, 37, 128, 1], device="cuda", dtype=torch.int32)
    chunk_lengths = lengths.clamp(min=16)  # a 16-token chunk ending each context
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    log_a = -torch.rand(1, 24, 256, device="cuda", generator=gen) * 0.5
    a = torch.rand(2, 256, 256, device="cuda", generator=gen) * 0.5 + 0.49
    return {
        "matmul": ((_rand(gen, 4, 1024), _rand(gen, 1024, 2816, scale=1024 ** -0.5)),
                   dict(activation="silu"), torch.bfloat16),
        "paged_attention-decode": ((_rand(gen, 4, 1, 16, 64), kp, vp, table, lengths - 1,
                                    lengths), {}, torch.bfloat16),
        "paged_attention-int8-chunk": ((_rand(gen, 4, 16, 16, 64), kq, vq, table,
                                        chunk_lengths - 16, chunk_lengths, ks, vs), {},
                                       torch.bfloat16),
        "flash_attention": ((_rand(gen, 1, 16, 128, 64), _rand(gen, 1, 16, 128, 64),
                             _rand(gen, 1, 16, 128, 64)), {}, torch.bfloat16),
        "ssd": ((torch.randn(1, 24, 256, 64, device="cuda", generator=gen) * 0.1,
                 torch.randn(1, 256, 64, device="cuda", generator=gen) * 0.3,
                 torch.randn(1, 256, 64, device="cuda", generator=gen) * 0.3, log_a), {},
                "scan"),
        "rglru": ((a, torch.randn(2, 256, 256, device="cuda", generator=gen)), {}, "scan"),
    }


@pytest.mark.parametrize("case", ["matmul", "paged_attention-decode",
                                  "paged_attention-int8-chunk", "flash_attention", "ssd",
                                  "rglru"])
def test_reference_schedules_match_the_kernels(cuda_device, case):
    """Each family's reference schedule (the oracle a fallback retries
    on) against its kernel at one serving shape, on the card: the kernel
    path launches its kernel, the reference path none, and they agree at
    the dtype's tolerance (bf16: ``TOL``; the fp32 scans: 1e-3, the
    sequential oracle's fp32 sums in another order than the chunked
    kernels')."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    args, opts, tol = _reference_cases(gen)[case]
    family = case.split("-")[0]
    kernels.reset_launch_counts()
    got = kernels.op(family)(*args, **opts)
    assert sum(kernels.launch_counts().values()) == 1
    with kernels.use_policy("reference"):
        want = kernels.op(family)(*args, **opts)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts().values()) == 1  # the oracle launched nothing
    if tol == "scan":
        torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=1e-3, atol=1e-3)
    else:
        close(got.float().cpu(), want.float().cpu(), tol)


def test_engine_on_card_retries_faulted_steps_on_the_reference(cuda_device):
    """The reduced qwen1.5-0.5b with ``kv_guard`` and ``kernel_fallback``
    under a plan that raises in one step, poisons another's logits and
    corrupts a cached page: every request drains, each kernel fault is
    one counted fallback, the chain is quarantined, the audit holds."""
    from repro_torch.serve import Fault, FaultPlan, ServeConfig

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    eng = PagedEngine(cfg, lm.init(cfg, seed=0), config=ServeConfig(
        max_slots=2, cache_len=64, page_size=8, kv_guard=True, kernel_fallback=True))
    prefix = list(range(5, 30))
    kernels.reset_fallback_stats()
    with FaultPlan([Fault("kernel.raise", at=2), Fault("kernel.nan", at=4),
                    Fault("page.corrupt", at=0)]) as plan:
        done = eng.run([Request(rid=i, prompt=prefix + [100 + i], max_new=6) for i in range(3)])
    eng.check()
    assert len(done) == 3 and all(len(r.out) == 6 for r in done)
    assert len(plan.fired) == 3
    assert kernels.fallback_stats().fallbacks == eng.stats()["kernel_fallbacks"] == 2
    assert eng.stats()["quarantined_pages"] > 0


# ---------------------------------------------------------------------------
# the recurrent slice: mamba2-780m and recurrentgemma-2b projections, and
# one decode step of each reduced model, kernels against plain versions
# ---------------------------------------------------------------------------

#: (label, k, n, linear keywords) of the recurrent models' projections:
#: mamba2's in_proj and out_proj, recurrentgemma's two branches (gelu and
#: bare), the RG-LRU gate (bias, sigmoid, fp32 out), the MQA projections
#: (q, k/v of one 256-wide head, o), the gelu_tanh GLU and its down
#: projection, and the tied fp32 logits
RECURRENT_PROJECTIONS = [
    ("mamba2-in", 1536, 6448, {}), ("mamba2-out", 3072, 1536, {}),
    ("rg-gate-branch", 2560, 2560, dict(activation="gelu")), ("rg-x-branch", 2560, 2560, {}),
    ("rg-lru-gate", 2560, 2560, dict(bias=True, activation="sigmoid", out_dtype=torch.float32)),
    ("rg-kv", 2560, 256, {}), ("rg-mlp-gate", 2560, 7680, dict(activation="gelu_tanh")),
    ("rg-mlp-down", 7680, 2560, {}), ("rg-logits", 2560, 256000, dict(logits=True)),
]


def _plain_kernels():
    """Route ``kernels.linear`` to the plain versions on CUDA tensors."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.kernels import api

    stack = ExitStack()
    for name, plain in (("matmul_tiled", matmul_tiled_plain), ("matmul_mcast", matmul_mcast_plain),
                        ("matmul_unicast", matmul_unicast_plain)):
        stack.enter_context(mock.patch.object(api, name, plain))
    return stack


@pytest.mark.parametrize("policy,kernel", [("tiled", "matmul_tiled"), ("mcast", "matmul_mcast"),
                                           ("unicast", "matmul_unicast")])
@pytest.mark.parametrize("m", [4, 45])
@pytest.mark.parametrize("case", RECURRENT_PROJECTIONS, ids=lambda c: c[0])
def test_recurrent_projections_match_plain(cuda_device, case, m, policy, kernel):
    """``kernels.linear`` at each projection of the recurrent models, at
    decode (4) and prefill (45) rows, under each policy: one launch of the
    policy's kernel on its tensor-core design, the same function as the
    plain versions (K4 and K5 run bias and activation after the product,
    as in the JAX package) within ``TOL`` (bf16) or 1e-4 (fp32 results)."""
    _, k, n, kw = case
    kw = dict(kw)
    logits = kw.pop("logits", False)
    gen = torch.Generator(device=cuda_device).manual_seed(k + n + m)
    if logits:  # fp32 activations x the bf16 (vocab, d) table read transposed
        a, b = _rand(gen, m, k, dtype=torch.float32, scale=4.0), _rand(gen, n, k, scale=0.02).t()
    else:
        a, b = _rand(gen, m, k), _rand(gen, k, n, scale=k ** -0.5)
    bias = _rand(gen, n) if kw.pop("bias", False) else None
    kernels.reset_launch_counts()
    got = kernels.linear(a, b, bias=bias, policy=policy, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kernel] == 1 == sum(kernels.launch_counts().values())
    assert kernels.KERNELS[kernel].design == ("wgmma-swapab-3xbf16" if logits else "wgmma-swapab")
    with _plain_kernels():
        want = kernels.linear(a, b, bias=bias, policy=policy, **kw)
    assert got.dtype == want.dtype == kw.get("out_dtype", a.dtype)
    # K1 rounds once, to the output dtype; K4 and K5 round the product to
    # a's dtype before the epilogue, so a bf16 product's fp32 sigmoid
    # carries bf16 error
    if (got.dtype if policy == "tiled" else a.dtype) == torch.float32:
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-4)
    else:
        close(got.cpu(), want.float().cpu(), torch.bfloat16)


class _LayerHold:
    """Each mixer, MLP and logits call of a kernel run, rerun on its own
    inputs through the plain versions: the largest error over 2e-2 x the
    plain output's largest magnitude (chip_smoke's ``TOL_MODEL``)."""

    def __init__(self):
        self.worst, self.calls = 0.0, 0

    def armed(self):
        from contextlib import ExitStack
        from unittest import mock

        from repro_torch.nn import attention, rglru, ssd

        stack = ExitStack()
        for mod, name in ((attention, "attention"), (attention, "decode_attention"),
                          (rglru, "rglru"), (rglru, "rglru_step"), (ssd, "ssd"),
                          (ssd, "ssd_step"), (lm, "mlp"), (lm, "_logits")):
            real = getattr(mod, name)

            def held(*args, _real=real, _name=name, **kw):
                plain_args = args
                if _name == "decode_attention":  # the rerun attends over a copy of the ring
                    cache = args[2]
                    plain_args = (*args[:2], type(cache)(*(x.clone() for x in cache)), *args[3:])
                out = _real(*args, **kw)
                with _plain_kernels():
                    want = _real(*plain_args, **kw)
                got, ref = (out[0], want[0]) if isinstance(out, tuple) else (out, want)
                err = float((got.float() - ref.float()).abs().max())
                self.worst = max(self.worst, err / (2e-2 * float(ref.float().abs().max())))
                self.calls += 1
                return out

            stack.enter_context(mock.patch.object(mod, name, held))
        return stack


@pytest.mark.parametrize("policy", [None, "mcast", "unicast"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_recurrent_decode_step_matches_plain(cuda_device, arch, policy):
    """One decode step of the reduced model for a batch of 3 after a
    13-token prefill (caches copied to every slot): every mixer, MLP and
    the logits held to the plain versions on the kernel run's own inputs,
    the whole step's logits to the plain run's within 2e-2 x max |logit|,
    and only the policy's matmul kernel launched."""
    cfg = get_config(arch, reduced=True)
    params = lm.init(cfg, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (1, 13), device=cuda_device, generator=gen)
    step = torch.randint(0, cfg.vocab, (3, 1), device=cuda_device, generator=gen)

    def run():
        caches = lm.init_cache(cfg, 3, 32)
        _, one = lm.prefill(params, cfg, prompt, cache_slots=32)
        for full, c in zip(caches, one):
            for dst, src in zip(full, c):
                dst[:] = src
        return lm.decode_step(params, cfg, caches, step, 13)[0]

    hold = _LayerHold()
    kernel = {None: "matmul_tiled", "mcast": "matmul_mcast", "unicast": "matmul_unicast"}[policy]
    with kernels.use_policy(policy):
        kernels.reset_launch_counts()
        with hold.armed():
            got = run()
        counts = kernels.launch_counts()
        with _plain_kernels():
            want = run()
    torch.cuda.synchronize()
    assert counts[kernel] > 0 and sum(counts.values()) == counts[kernel], counts
    assert hold.calls > cfg.n_layers and hold.worst <= 1, hold.worst
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=2e-2, atol=2e-2 * scale)
