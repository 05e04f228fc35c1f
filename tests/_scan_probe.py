"""Where K9's and K10's time goes at mamba2-780m's width, and what their
accuracy rests on.

    python3 tests/_scan_probe.py

from the root of a checkout, on a machine with one CUDA card.  It prints
the card line and then one JSON line each for:

* ``mma_rate``: the rate of ``mma.sync.m16n8k8`` on TF32 operands, from a
  microbenchmark built with nvcc from the source below (eight independent
  accumulators a warp, 4, 8 and 16 warps an SM);
* each variant of the SSD sources — ``src/`` and ``chip_smoke.py`` copied
  into a temporary directory and a line or two edited there, the checkout
  never touched — with the device ms of each CUDA launch of one K9 and one K10
  call at mamba2-780m (``torch.profiler``, mean of 5 calls) and each
  output's err_over_allowance against the plain versions at ``TOL_SCAN``
  at mamba2-780m and the 256 KB state (``chip_smoke``'s draws, seed 0):
  "as built"; "no NaN test" (the big part rounded without its fp32
  compare: a NaN input can come out finite); "exponent test on both
  parts" (an integer test of each part's exponent instead);
  "products skipped" (the warp GEMM returns at once: what the copies, the
  state passes and the stores cost); "one TF32 pass" (both kernels);
  "cvt.rna" (the TF32 rounding by ``cvt.rna.tf32.f32``, which ptxas
  expands to four instructions, instead of two integer operations).  The
  outputs of "products skipped" and "one TF32 pass" are wrong by
  construction;
* ``first_step``: ``tests/test_torch_cuda.py``'s 256 KB-state draw, where
  y at the first step is one product (C_0 . B_0) xdt_0 whose sum over
  N = 1024 cancels: the worst err_over_allowance of K9 and of the plain
  version against the recurrence in fp64, and where it lies.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/csrc/"
GEMM_HEAD = "const int sh = ((threadIdx.x & 31) >> 2 & 3) << 3;"
THREE_PASSES = """        mma0(part, as[i], bb[j]);
        mma(part, ab[i], bs[j]);
        mma(part, ab[i], bb[j]);
"""
ROUNDING = "{ return (bits + 0x1000u) & 0xffffe000u; }"
BIG = "big = x == x ? tf32(__float_as_uint(x)) : __float_as_uint(x);"
VARIANTS = {
    "as built": [],
    "no NaN test": [(CSRC + "ssd_common.cuh", BIG, "big = tf32(__float_as_uint(x));")],
    "exponent test on both parts": [
        (CSRC + "ssd_common.cuh", BIG, "big = tf32(__float_as_uint(x));"),
        (CSRC + "ssd_common.cuh", ROUNDING,
         "{ return (bits & 0x7f800000u) == 0x7f800000u ? bits : (bits + 0x1000u) & 0xffffe000u; }")],
    "products skipped": [(CSRC + "ssd_common.cuh", GEMM_HEAD, GEMM_HEAD + " return;")],
    "one TF32 pass": [(CSRC + "ssd_common.cuh", THREE_PASSES,
                       "        mma0(part, ab[i], bb[j]);\n")],
    "cvt.rna": [(CSRC + "ssd_common.cuh", ROUNDING,
                 "{ uint32_t r; "
                 'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(__uint_as_float(bits))); '
                 "return r; }")],
}

MMA_RATE = r'''
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__global__ void k(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + i);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 2 * 512 * sizeof(float));
  const int iters = 4096;
  for (int warps : {4, 8, 16}) {
    const int blocks = sms * 2, threads = warps * 32 / 2;
    k<<<blocks, threads>>>(out, 16);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    cudaEventRecord(e0);
    k<<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flops = 2.0 * 16 * 8 * 8 * 8 * (double)iters * blocks * threads / 32;
    printf("%d %.6f %.3f\n", warps, ms, flops / ms / 1e9);
  }
  return cudaGetLastError();
}
'''

RUN = r'''
import json, sys, torch
import chip_smoke as s
from torch.profiler import ProfilerActivity, profile

variant = sys.argv[1]
s._build.build_all(["ssd_scan", "ssd_scan_bwd"])


def ratio(got, want):
    return float(s.flash_ratios(got, want, s.TOL_SCAN).max())


rec = dict(variant=variant, err_over_allowance={})
for c in (s.SSD_SHAPES[0], s.SSD_SHAPES[3]):
    gen = torch.Generator(device="cuda").manual_seed(0)
    xdt, bm, cm, log_a, dy = s._ssd_inputs(gen, c)
    lcum = s.ssd_lcum(log_a, s.SSD_CHUNK)
    y, st = s.ssd_scan(xdt, bm, cm, lcum, return_states=True)
    y_p, st_p = s.ssd_scan_plain(xdt, bm, cm, lcum, return_states=True)
    bwd = (xdt, bm, cm, lcum, st_p, dy)
    got, want = s.ssd_scan_bwd(*bwd), s.ssd_scan_bwd_plain(*bwd)
    torch.cuda.synchronize()
    errs = dict(y=ratio(y, y_p), states=ratio(st, st_p))
    for name, g, w in zip(("dx", "db", "dc"), got, want):
        errs[name] = ratio(g, w)
    errs["dl"] = ratio(got[3][..., 0], want[3][..., 0])
    rec["err_over_allowance"][c.label] = errs
    if c is s.SSD_SHAPES[0]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                s.ssd_scan(xdt, bm, cm, lcum)
                s.ssd_scan_bwd(*bwd)
            torch.cuda.synchronize()
        launches = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            name = e.key.split("::")[-1].split("(")[0]
            if t and name.startswith("ssd_"):
                launches[name] = t / e.count / 1e3
        rec["launch_ms"] = launches
    del got, want, st, st_p
print(json.dumps(rec), flush=True)
'''

FIRST_STEP = r'''
import json, sys, torch
sys.path.insert(0, "tests")
import chip_smoke as s
from test_torch_cuda import _ssd_fp64, _ssd_inputs

shape = (1, 2, 256, 64, 1024)
gen = torch.Generator(device="cuda").manual_seed(sum(shape))
xdt, bm, cm, log_a, dy = _ssd_inputs(gen, *shape)
lcum = s.ssd_lcum(log_a, s.SSD_CHUNK)
want = _ssd_fp64(xdt, bm, cm, lcum, dy)[0]
rec = dict(check="first_step", shape=shape)
for name, fn in (("kernel", s.ssd_scan), ("plain", s.ssd_scan_plain)):
    r = s.flash_ratios(fn(xdt, bm, cm, lcum), want, s.TOL_SCAN)
    at = [int(i) for i in torch.nonzero(r == r.max())[0]]
    rec[name] = dict(err_over_allowance=float(r.max()), at=at)
print(json.dumps(rec), flush=True)
'''


def mma_rate(tmp: Path) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    src, exe = tmp / "mma_rate.cu", tmp / "mma_rate"
    src.write_text(MMA_RATE)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(exe), str(src)], check=True)
    rows = [ln.split() for ln in subprocess.run([str(exe)], check=True, capture_output=True,
                                                 text=True).stdout.splitlines()]
    return dict(check="mma_rate", tflops_by_warps_per_sm={int(w): float(t) / 1e3
                                                          for w, _, t in rows})


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(mma_rate(Path(tmp))), flush=True)
    for variant, edits in VARIANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            for source, line, changed in edits:
                text = (copy / source).read_text()
                if text.count(line) != 1:
                    sys.exit(f"{source}: expected the line {line!r} once")
                (copy / source).write_text(text.replace(line, changed))
            subprocess.run([sys.executable, "-c", RUN, variant], cwd=copy, check=True)
    subprocess.run([sys.executable, "-c", FIRST_STEP], cwd=ROOT, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
