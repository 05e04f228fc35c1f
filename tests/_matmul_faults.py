"""Planted faults in the matmul kernels K1, K4 and K5 (``csrc/matmul_wgmma.cuh``,
``csrc/matmul_tiled.cu``, ``csrc/matmul_mcast.cu``), to show that
``chip_smoke.py``'s matmul checks catch them at its matmul shapes.

    python3 tests/_matmul_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one line of one kernel source there (the checkout is
never touched), builds the copy's kernels that include that source and
runs each against its plain version at every shape of
``chip_smoke.check_schedules`` — K1 with a bf16 bias and silu (the fp32
logits without either), K4 and K5 as there — and at the grouped shapes
of ``GROUPED`` in ``CHECK`` (a stack of expert products in one launch: a
K split over 3 groups, the moonshot experts' decode gate), judged as
``chip_smoke.check_close`` judges it: |got - want| <= tol (1 + |want|),
tol 2e-2 for bf16 outputs and 1e-4 for the fp32 logits.  Outputs are
allocated over NaN-filled memory, so an element no CTA writes fails.
The faults run in parallel, one process each.  One JSON line per (fault,
kernel, shape) gives the design that ran, the verdict and the worst error
over its allowance (> 1 fails).

A fault must fail every (kernel, shape) it touches by at least 10x and
every other one must pass; the script exits 1 otherwise.  Two faults
break only the grouped form: the groups' split-K counters collapsed onto
group 0's, and every group's B k-tiles loaded from group 0.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/csrc")
MATMULS = ("matmul_tiled", "matmul_mcast", "matmul_unicast")
# the kernels built from each source
USERS = {"matmul_wgmma.cuh": MATMULS, "matmul_tiled.cu": ("matmul_tiled",),
         "matmul_mcast.cu": ("matmul_mcast",)}


def swapab_split(kernel, design, splits, groups):
    return design.startswith("wgmma-swapab") and splits > 1


# name -> (source, the line as written, the line with the fault, the
# (kernel, design, K split, groups) runs it touches)
FAULTS = {
    # the swapab fix-up sums every split's partial but the first
    "one split-K partial dropped": (
        "matmul_wgmma.cuh",
        "for (int p = 0; p < splits; ++p) sum +=",
        "for (int p = 1; p < splits; ++p) sum +=",
        swapab_split),
    # gemm_wgmma's k-tile count: the last (tail) k-tile is not walked
    "K tail off by one (wgmma)": (
        "matmul_wgmma.cuh",
        "const int steps = (K + BK - 1) / BK;",
        "const int steps = (K - 1) / BK;",
        lambda kernel, design, splits, groups: design in ("wgmma", "wgmma-cluster")),
    # grouped split K: every group's CTAs count on group 0's tile counters
    "groups share the split-K counters": (
        "matmul_wgmma.cuh",
        "    counters += g * gridDim.x;",
        "    counters += 0 * gridDim.x;",
        lambda kernel, design, splits, groups: swapab_split(kernel, design, splits, groups)
        and groups > 1),
    # grouped swapab: every group's B k-tiles come from group 0
    "B loaded from group 0 (swapab)": (
        "matmul_wgmma.cuh",
        "load_tile<BKM, SMALL_BN>(bslot(s), &tb, bar, n0, (kt0 + i) * BK, g);",
        "load_tile<BKM, SMALL_BN>(bslot(s), &tb, bar, n0, (kt0 + i) * BK, 0);",
        lambda kernel, design, splits, groups: design.startswith("wgmma-swapab")
        and groups > 1),
    # K1's split-K epilogue: the last CTA's sum gets no bias
    "K1: the last CTA's sum drops the bias": (
        "matmul_wgmma.cuh",
        "epi.store(m, n, act(sum + epi.bias(n)));",
        "epi.store(m, n, act(sum));",
        lambda kernel, design, splits, groups: kernel == "matmul_tiled"
        and swapab_split(kernel, design, splits, groups)),
    # K1's split-K epilogue: each split's partial passes the activation
    "K1: activation on each split's partial": (
        "matmul_wgmma.cuh",
        "if (m < M && n < N) part[(long long)m * N + n] = acc[j];",
        "epi.with_act([&](auto act) { if (m < M && n < N) part[(long long)m * N + n] = "
        "act(acc[j]); });",
        lambda kernel, design, splits, groups: kernel == "matmul_tiled"
        and swapab_split(kernel, design, splits, groups)),
    # K1's grouped raster sends row blocks 2i and 2i + 1 of a group to one tile
    "K1: grouped raster maps two CTAs to one tile": (
        "matmul_tiled.cu",
        "m0 = (first_m + pid % per_group % group_rows) * LARGE_BM;",
        "m0 = (first_m + pid % per_group % group_rows / 2 * 2) * LARGE_BM;",
        lambda kernel, design, splits, groups: design == "wgmma"),
    # K4's multicast: ranks 2i and 2i + 1 both issue slice 2i of each B k-tile
    "K4: multicast delivers one B slice twice": (
        "matmul_wgmma.cuh",
        "const int slice = CL > 1 ? (int)cluster_rank() : 0;",
        "const int slice = CL > 1 ? (int)(cluster_rank() & ~1u) : 0;",
        lambda kernel, design, splits, groups: design == "wgmma-cluster"),
    # K4's cluster raster: ranks 2i and 2i + 1 both take row block i
    "K4: cluster rank picks the wrong A row block": (
        "matmul_mcast.cu",
        "m0 = (blockIdx.x / CL * CL + (int)cluster_rank()) * LARGE_BM;",
        "m0 = (blockIdx.x / CL * CL + (int)cluster_rank() / 2) * LARGE_BM;",
        lambda kernel, design, splits, groups: design == "wgmma-cluster"),
}
CATCH = 10.0  # a touched run fails by at least this much

CHECK = r'''
import json, math, sys, torch
import chip_smoke as s
from repro_torch import kernels
from repro_torch.kernels.matmul import matmul_tiled_plain

fault, names = sys.argv[1], sys.argv[2].split(",")
# (g, m, k, n) of the grouped runs: K split 16 ways (one k-tile a split)
# over 3 groups, and 64 expert products at moonshot-v1-16b-a3b's decode
# gate (no split)
GROUPED = ((3, 5, 1024, 64), (64, 24, 2048, 1408))
s._build.build_all(names)
gen = torch.Generator(device="cuda").manual_seed(0)
for m, k, n, logits in s.SCHEDULE_SHAPES:
    if logits:
        a = torch.randn(m, k, device="cuda", generator=gen) * 4
        b = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(torch.bfloat16).t()
        bias = None
    else:
        a = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        b = (torch.randn(k, n, device="cuda", generator=gen) / math.sqrt(k)).to(torch.bfloat16)
        bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    tol = s.TOL_FP32 if a.dtype == torch.float32 else s.TOL_BF16
    for name in names:
        fn = kernels.KERNELS[name]
        if name == "matmul_tiled":
            act = "none" if logits else "silu"
            run = lambda: fn(a, b, bias, activation=act)
            want = matmul_tiled_plain(a, b, bias, activation=act).float()
        else:
            run = lambda: fn(a, b)
            want = s.matmul_unicast_plain(a, b).float()
        torch.full((m, n), float("nan"), dtype=a.dtype, device="cuda")  # freed: run's output
        got = run().float()
        torch.cuda.synchronize()
        ratio = torch.nan_to_num((got - want).abs() / (tol + tol * want.abs()), nan=math.inf)
        worst = float(ratio.max())
        lib = s._build.load(name)
        print(json.dumps(dict(fault=fault, kernel=name, shape=[m, k, n], design=fn.design,
                              splits=getattr(lib, f"{name}_splits")(n, k, 1), groups=1,
                              verdict="passes" if worst <= 1 else "fails",
                              err_over_allowance=worst)), flush=True)
for g, m, k, n in GROUPED:
    a = torch.randn(g, m, k, device="cuda", generator=gen).to(torch.bfloat16)
    b = (torch.randn(g, k, n, device="cuda", generator=gen) / math.sqrt(k)).to(torch.bfloat16)
    bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    for name in names:
        fn = kernels.KERNELS[name]
        if name == "matmul_tiled":
            run = lambda: fn(a, b, bias, activation="silu")
            want = matmul_tiled_plain(a, b, bias, activation="silu").float()
        else:
            run = lambda: fn(a, b)
            want = s.matmul_unicast_plain(a, b).float()
        torch.full((g, m, n), float("nan"), dtype=a.dtype, device="cuda")
        got = run().float()
        torch.cuda.synchronize()
        tol = s.TOL_BF16
        ratio = torch.nan_to_num((got - want).abs() / (tol + tol * want.abs()), nan=math.inf)
        worst = float(ratio.max())
        lib = s._build.load(name)
        print(json.dumps(dict(fault=fault, kernel=name, shape=[g, m, k, n], design=fn.design,
                              splits=getattr(lib, f"{name}_splits")(n, k, g), groups=g,
                              verdict="passes" if worst <= 1 else "fails",
                              err_over_allowance=worst)), flush=True)
'''


def main() -> int:
    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for i, (fault, (source, line, broken, _)) in enumerate(FAULTS.items()):
            copy = Path(tmp) / str(i)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            path = copy / CSRC / source
            text = path.read_text()
            if text.count(line) != 1:
                sys.exit(f"{CSRC / source}: expected the line {line!r} once")
            path.write_text(text.replace(line, broken))
            runs[fault] = subprocess.Popen(
                [sys.executable, "-c", CHECK, fault, ",".join(USERS[source])], cwd=copy,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fault, proc in runs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"{fault}: the check failed to run:\n{err[-4000:]}")
            touches = FAULTS[fault][3]
            for rec in map(json.loads, out.splitlines()):
                print(json.dumps(rec), flush=True)
                touched = touches(rec["kernel"], rec["design"], rec["splits"], rec["groups"])
                caught = rec["verdict"] == "fails" and rec["err_over_allowance"] >= CATCH
                if touched != caught or (not touched and rec["verdict"] != "passes"):
                    wrong.append((fault, rec["kernel"], rec["shape"], rec["verdict"],
                                  rec["err_over_allowance"]))
    print(json.dumps({"faults": len(FAULTS), "unexpected": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
