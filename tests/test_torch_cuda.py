"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (the ``cuda_device`` fixture)
and skips without one; this file imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from _torch_util import close, cuda_device  # noqa: F401 (fixture)
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.matmul import ACTIVATIONS, matmul_tiled, matmul_tiled_plain
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


def test_engine_on_card_launches_every_kernel(cuda_device):
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = lm.init(cfg, seed=0)
    eng = PagedEngine(cfg, params, max_batch=2, cache_len=64, page_size=8)
    prefix = list(range(5, 30))
    kernels.reset_launch_counts()
    done = eng.run([Request(rid=i, prompt=prefix + [100 + i], max_new=4) for i in range(3)])
    eng.check()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    assert all(n > 0 for n in kernels.launch_counts().values()), kernels.launch_counts()
