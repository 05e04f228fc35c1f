"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card.  Phases,
each fatal on failure (nothing is caught):

1. build the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) and print the card's name and power limit;
2. hold every kernel against its plain PyTorch version on the card at
   the serving path's shapes, timing kernel, plain version and a PyTorch
   library call with CUDA events (median of 25 runs, L2 flushed before
   each), beside the least time the card could take (``bound_ms``);
3. build qwen1.5-0.5b at full width from a seed and compare one prefill
   and one paged decode step run through the kernels with the same run
   through the plain versions;
4. serve 8 requests (32-token shared prefix, 40-60-token prompts, 32 new
   tokens each) through ``PagedEngine`` and check that every kernel was
   launched by that run, that every request drained and that the pool
   audit is green.

It prints one JSON line per check, then the card line, the kernel
summary and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or run outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch/csrc not found)")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels.matmul import matmul_tiled, matmul_tiled_plain  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    gather_pages,
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_prefill,
    paged_attention_prefill_plain,
)
from repro_torch.kernels.paged_attention.paged_attention import prefill_chunk  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import PagedEngine, Request, ServeConfig  # noqa: E402

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.  They assume the 700 W limit; the card line says the
# limit this run had.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

# Stated tolerances (compared in fp32).  bf16 outputs: 2e-2 absolute and
# relative, about two bf16 ulps — kernel and plain version sum in other
# orders, so a rounding can land on the other side of a tie.  fp32
# outputs of K1 (the logits): 1e-4, the reordered fp32 sum over K=1024.
TOL_BF16 = 2e-2
TOL_FP32 = 1e-4
# whole-model logits: fp32, but built on 24 layers of bf16 activations in
# which such ties recur; held to 2e-2 of the largest logit.
TOL_MODEL = 2e-2

KERNEL_META = {
    "matmul_tiled": ("src/repro_torch/csrc/matmul_tiled.cu",
                     "src/repro/kernels/matmul/matmul.py:153"),
    "paged_attention_decode": ("src/repro_torch/csrc/paged_attention_decode.cu",
                               "src/repro/kernels/paged_attention/paged_attention.py:105"),
    "paged_attention_prefill": ("src/repro_torch/csrc/paged_attention_prefill.cu",
                                "src/repro/kernels/paged_attention/paged_attention.py:240"),
}

def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None
SPIN_HZ = 2.0e9  # cycles per second for torch.cuda._sleep (above the H100's clock)


def time_ms(fn, runs: int = 25, warmup: int = 3, max_spin_s: float = 0.05) -> tuple[float, float]:
    """(median device ms, host ms) of one ``fn()``: device time by CUDA
    events over ``runs``, host time as the wall time to enqueue it.

    Before each run the 50 MB L2 cache is flushed, as the serving path
    finds its weights (a decode step streams far more than L2 holds), and
    the card is kept busy with a spin kernel longer than the host takes
    to enqueue ``fn``, so the events bracket device work only and not the
    Python and launch overhead between them."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(min(max(4 * host_s, 2e-4), max_spin_s) * SPIN_HZ)
    times = []
    for _ in range(runs):
        _FLUSH.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), host_s * 1e3


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name: str, got, want, tol: float) -> float:
    """|got - want| <= tol + tol * |want| elementwise (rtol = atol = tol)."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    ok = bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= tol + tol * w.abs()).all())
    err = max_err(got, want)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree beyond rtol=atol="
                             f"{tol} (max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_matmul(gen, m, k, n, *, bias=True, activation="none", logits=False):
    dev = "cuda"
    if logits:  # fp32 activations x the bf16 (vocab, d) table read transposed
        a = torch.randn(m, k, device=dev, generator=gen) * 4
        table = (torch.randn(n, k, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        b = table.t()
        bb = None
    else:
        a = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        b = (torch.randn(k, n, device=dev, generator=gen) / math.sqrt(k)).to(torch.bfloat16)
        bb = torch.randn(n, device=dev, generator=gen).to(torch.bfloat16) if bias else None
    before = matmul_tiled.launches
    got = matmul_tiled(a, b, bb, activation=activation)
    assert matmul_tiled.launches == before + 1
    want = matmul_tiled_plain(a, b, bb, activation=activation)
    tol = TOL_FP32 if got.dtype == torch.float32 else TOL_BF16
    err = check_close(f"matmul_tiled {m}x{k}x{n}", got, want, tol)
    out_bytes = m * n * got.element_size()
    nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() + out_bytes \
        + (0 if bb is None else bb.numel() * bb.element_size())
    b_ms, b_by = bound(2.0 * m * n * k, nbytes,
                       PEAK_FP32 if a.dtype == torch.float32 else PEAK_BF16)
    if logits:
        library, lib_ms = None, None  # no single call multiplies fp32 by a bf16 view
    elif bb is not None and activation == "none":
        library, lib_ms = "torch.addmm", time_ms(lambda: torch.addmm(bb, a, b))[0]
    else:
        library = "torch.matmul (no epilogue)"
        lib_ms = time_ms(lambda: torch.matmul(a, b))[0]
    k_ms, k_host = time_ms(lambda: matmul_tiled(a, b, bb, activation=activation))
    rec = dict(check="kernel", name="matmul_tiled", shape=[m, k, n],
               a_dtype=str(a.dtype), b_dtype=str(b.dtype), out_dtype=str(got.dtype),
               bias=bb is not None, activation=activation, kernel_ms=k_ms, host_ms=k_host,
               plain_ms=time_ms(lambda: matmul_tiled_plain(a, b, bb, activation=activation))[0],
               library=library, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_err=err, tol=tol)
    emit(rec)
    return rec


def _pool(gen, kvh, b, n, ps, d, quant=False):
    """A page pool with a distinct page chain per sequence (page 0 null)."""
    shape = (kvh, 1 + b * n, ps, d)
    if quant:
        k = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        ks = (torch.rand(*shape[:3], 1, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        vs = (torch.rand(*shape[:3], 1, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        return k, v, ks, vs
    k = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    return k, torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16), None, None


def _sdpa_over_pages(q, k_pages, v_pages, table, start, lengths, k_scale=None, v_scale=None):
    """The library yardstick: scaled_dot_product_attention over the K/V
    gathered from the pages (gather outside the timed call)."""
    b, s, h, d = q.shape
    kvh = k_pages.shape[0]
    k = gather_pages(k_pages, table)
    v = gather_pages(v_pages, table)
    if k_scale is not None:
        k = (k.float() * gather_pages(k_scale, table).float()).to(torch.bfloat16)
        v = (v.float() * gather_pages(v_scale, table).float()).to(torch.bfloat16)
    t = k.shape[1]
    k = k.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    qpos = start.long()[:, None] + torch.arange(s, device=q.device)[None]
    kpos = torch.arange(t, device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) \
        & (kpos[None, None, :] < lengths.long()[:, None, None])
    qh = q.permute(0, 2, 1, 3)
    mask = mask[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def _attn_work(start, lengths, s, ps, kvh, h, d, kv_bytes, scale_bytes=0):
    """Bytes and flops this data needs: the K/V pages each (sequence, query
    chunk) must read, and QK + PV over the (row, key) pairs that are valid."""
    nbytes, flops = 0.0, 0.0
    group = h // kvh
    qc = prefill_chunk(s, group) if s > 1 else 1
    for st, ln in zip(start.tolist(), lengths.tolist()):
        if ln <= 0:
            continue
        for c0 in range(0, s, qc):
            last = st + min(s, c0 + qc) - 1
            pages = min(-(-ln // ps), last // ps + 1)
            nbytes += kvh * pages * ps * (2 * d * kv_bytes + 2 * scale_bytes)
        for t in range(s):
            keys = min(ln, st + t + 1)
            flops += 4.0 * h * keys * d
    return nbytes, flops


def check_decode(gen, *, b=4, h=16, kvh=16, d=64, ps=16, n=16, lengths=(256, 200, 37, 129)):
    kp, vp, _, _ = _pool(gen, kvh, b, n, ps, d)
    table = torch.arange(1, 1 + b * n, device="cuda", dtype=torch.int32).reshape(b, n)
    lengths = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    start = lengths - 1
    q = torch.randn(b, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    before = paged_attention_decode.launches
    got = paged_attention_decode(q, kp, vp, table, start, lengths)
    assert paged_attention_decode.launches == before + 1
    want = paged_attention_decode_plain(q, kp, vp, table, start, lengths)
    err = check_close(f"paged_attention_decode kvh={kvh}", got, want, TOL_BF16)
    kv_bytes, flops = _attn_work(start, lengths, 1, ps, kvh, h, d, 2)
    nbytes = kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 + 2 * b * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
    k_ms, k_host = time_ms(lambda: paged_attention_decode(q, kp, vp, table, start, lengths))
    rec = dict(check="kernel", name="paged_attention_decode", b=b, h=h, kvh=kvh, d=d, ps=ps,
               pages_per_seq=n, lengths=lengths.tolist(), kernel_ms=k_ms, host_ms=k_host,
               plain_ms=time_ms(lambda: paged_attention_decode_plain(q, kp, vp, table, start,
                                                                     lengths))[0],
               library="scaled_dot_product_attention over gathered pages",
               library_ms=time_ms(_sdpa_over_pages(q[:, None], kp, vp, table, start,
                                                   lengths))[0],
               bound_ms=b_ms, bound_by=b_by, max_err=err, tol=TOL_BF16)
    emit(rec)
    return rec


def check_prefill(gen, *, b=1, s=16, h=16, kvh=16, d=64, ps=16, n=16, lengths=(48,),
                  quant=False):
    kp, vp, ks, vs = _pool(gen, kvh, b, n, ps, d, quant=quant)
    table = torch.arange(1, 1 + b * n, device="cuda", dtype=torch.int32).reshape(b, n)
    lengths = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    start = torch.clamp(lengths - s, min=0)
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs)
    before = paged_attention_prefill.launches
    got = paged_attention_prefill(q, kp, vp, table, start, lengths, **kw)
    assert paged_attention_prefill.launches == before + 1
    want = paged_attention_prefill_plain(q, kp, vp, table, start, lengths, **kw)
    err = check_close(f"paged_attention_prefill s={s} quant={quant}", got, want, TOL_BF16)
    kv_bytes, flops = _attn_work(start, lengths, s, ps, kvh, h, d, kp.element_size(),
                                 2 if quant else 0)
    nbytes = kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 + 2 * b * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
    k_ms, k_host = time_ms(lambda: paged_attention_prefill(q, kp, vp, table, start, lengths,
                                                           **kw))
    rec = dict(check="kernel", name="paged_attention_prefill", b=b, s=s, h=h, kvh=kvh, d=d,
               ps=ps, pages_per_seq=n, lengths=lengths.tolist(), int8=quant,
               kernel_ms=k_ms, host_ms=k_host,
               plain_ms=time_ms(lambda: paged_attention_prefill_plain(q, kp, vp, table, start,
                                                                      lengths, **kw))[0],
               library="scaled_dot_product_attention over gathered pages",
               library_ms=time_ms(_sdpa_over_pages(q, kp, vp, table, start, lengths, ks,
                                                   vs))[0],
               bound_ms=b_ms, bound_by=b_by, max_err=err, tol=TOL_BF16)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 3: the full model through the kernels and through the plain versions
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_versions():
    """Route the kernel layer to the plain versions (CUDA tensors and all)
    for a reference run; the port itself has no such switch."""
    with mock.patch.object(api, "matmul_tiled", matmul_tiled_plain), \
            mock.patch.object(api, "paged_attention_decode", paged_attention_decode_plain), \
            mock.patch.object(api, "paged_attention_prefill", paged_attention_prefill_plain):
        yield


def model_run(cfg, params, prompt, step_tokens, *, time_step=False):
    """One bucketed cold prefill scattered into pages, then one decode step
    for a batch of 4 against those pages; returns both logits (and, with
    ``time_step``, the decode step's device and host ms)."""
    pools = lm.init_paged_cache(cfg, 33, 16, device="cuda")
    n = len(prompt)  # 45 tokens: the 48-token bucket, as the engine pads it
    padded = torch.zeros((1, 48), dtype=torch.long, device="cuda")
    padded[0, :n] = prompt
    pre, dense = lm.prefill(params, cfg, padded, logit_index=n - 1)
    lm.prefill_to_pages(dense, pools, torch.tensor([1, 2, 3], device="cuda",
                                                   dtype=torch.int32), n)
    # four sequences share the first two prompt pages; each gets its own
    # copy of the third, which its decode token writes into
    table = torch.zeros((4, 16), dtype=torch.int32, device="cuda")
    table[:, :2] = torch.tensor([1, 2], dtype=torch.int32)
    table[:, 2] = torch.arange(5, 9, dtype=torch.int32)
    for c in pools:
        for t in c:
            t[:, 5:9] = t[:, 3:4]
    index = torch.full((4,), n, dtype=torch.long, device="cuda")
    lengths = torch.full((4,), n + 1, dtype=torch.int32, device="cuda")
    def step():
        return lm.decode_step(params, cfg, pools, step_tokens, index, block_table=table,
                              lengths=lengths)[0]

    dec = step()
    if time_step:  # the step rewrites the same rows: repeating it is idempotent
        return pre, dec, time_ms(step, runs=10, max_spin_s=1.0)
    return pre, dec


def check_model(cfg, params):
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    pre_k, dec_k, (step_ms, step_host_ms) = model_run(cfg, params, prompt, step,
                                                      time_step=True)
    emit(dict(check="decode_step_time", batch=4, context=len(prompt) + 1,
              device_ms=step_ms, host_ms=step_host_ms,
              device_busy_share=min(1.0, step_ms / step_host_ms)))
    with plain_versions():
        pre_p, dec_p = model_run(cfg, params, prompt, step)
    torch.cuda.synchronize()
    for name, got, want in (("prefill", pre_k, pre_p), ("decode_step", dec_k, dec_p)):
        err = max_err(got, want)
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        emit(dict(check="model", name=name, shape=list(got.shape), max_err=err,
                  max_abs_logit=scale, tol=TOL_MODEL * scale, argmax_agree=agree))
        if not (torch.isfinite(got).all() and err <= TOL_MODEL * scale):
            raise AssertionError(f"full model {name}: kernels vs plain versions max abs err "
                                 f"{err} > {TOL_MODEL} x {scale}")


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def check_serving(cfg, params):
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab, size=32)]
    reqs = [Request(rid=i, prompt=prefix + [int(t) for t in rng.integers(
        0, cfg.vocab, size=int(rng.integers(8, 29)))], max_new=32) for i in range(8)]
    engine = PagedEngine(cfg, params, config=ServeConfig(), device="cuda")
    first: dict[int, float] = {}
    admit = engine._admit

    def timed_admit(req):
        res = admit(req)
        if res is True and req.rid not in first:
            first[req.rid] = time.perf_counter() - t0  # the sampler synced the card
        return res

    engine._admit = timed_admit
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    engine.check()
    stats = engine.stats()
    n_tok = sum(len(r.out) for r in done)
    rec = dict(check="serving", requests=len(done), new_tokens=n_tok,
               prompt_lens=[len(r.prompt) for r in reqs], wall_s=wall,
               tokens_per_s=n_tok / wall, ttft_median_s=statistics.median(first.values()),
               launches=launches, prefix_hit_tokens=stats["prefix_hit_tokens"],
               kernel_calls=stats["kernel_calls"])
    emit(rec)
    if len(done) != len(reqs) or any(len(r.out) != r.max_new for r in done):
        raise AssertionError("serving: not every request drained with max_new tokens")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"serving: kernels never launched on the main path: {missing}")
    return launches


# ---------------------------------------------------------------------------


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False — this check needs a "
                 "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain fp32 path stays fp32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    build_s = _build.build_all()
    emit(dict(check="build", seconds=build_s, flags=" ".join(_build.NVCC_FLAGS)))
    for kname in _build.KERNELS:
        for line in _build.ptxas_report(kname).splitlines():
            if "Used" in line:
                print(f"# ptxas {kname}: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    mm = [check_matmul(gen, 4, 1024, 1024),                      # decode q/k/v (+bias)
          check_matmul(gen, 4, 1024, 2816, bias=False, activation="silu"),  # decode gate
          check_matmul(gen, 4, 2816, 1024, bias=False),          # decode down projection
          check_matmul(gen, 48, 1024, 2816, bias=False, activation="silu"),  # prefill gate
          check_matmul(gen, 4, 1024, 151936, logits=True)]       # tied logits, fp32
    summary["matmul_tiled"] = mm[0]
    summary["paged_attention_decode"] = check_decode(gen)
    check_decode(gen, h=16, kvh=4)                               # GQA
    summary["paged_attention_prefill"] = check_prefill(gen)
    check_prefill(gen, s=5, lengths=(37,), kvh=4)                # ragged suffix, GQA
    check_prefill(gen, quant=True)                               # int8 pools

    cfg = get_config("qwen1.5-0.5b")
    params = lm.init(cfg, seed=0, device="cuda")
    check_model(cfg, params)
    launches = check_serving(cfg, params)

    kernels_line = []
    for kname, rec in summary.items():
        source, replaces = KERNEL_META[kname]
        kernels_line.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=rec["max_err"], ms=rec["kernel_ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"]))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
