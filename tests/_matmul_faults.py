"""Planted faults in K5 (``csrc/matmul_unicast.cu``), to show that
``chip_smoke.py``'s matmul checks catch them at its K5 shapes.

    python3 tests/_matmul_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one line of the kernel source there (the checkout is
never touched), builds the copy's K5 and runs it against its plain
version at every shape of ``chip_smoke.check_schedules``, judged as
``chip_smoke.check_close`` judges it: |got - want| <= tol (1 + |want|),
tol 2e-2 for bf16 outputs and 1e-4 for the fp32 logits.  One JSON line
per (fault, shape) gives the design that ran, the verdict and the worst
error over its allowance (> 1 fails).

A fault must fail every shape it touches by at least 10x and every other
shape must pass; the script exits 1 otherwise.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/csrc/matmul_unicast.cu")

# name -> (the line as written, the line with the fault, the shapes it
# touches: a predicate on (design, K split) of the call)
FAULTS = {
    # the fix-up of wgmma-swapab sums every split's partial but the first
    "one split-K partial dropped": (
        "for (int p = 0; p < splits; ++p) sum +=",
        "for (int p = 1; p < splits; ++p) sum +=",
        lambda design, splits: design.startswith("wgmma-swapab") and splits > 1),
    # the wgmma design's k-tile count: the last (tail) k-tile is not walked
    "K tail off by one (wgmma)": (
        "const int steps = (K + BK - 1) / BK;",
        "const int steps = (K - 1) / BK;",
        lambda design, splits: design == "wgmma"),
}
CATCH = 10.0  # a touched shape fails by at least this much

CHECK = r'''
import json, math, sys, torch
import chip_smoke as s
from repro_torch.kernels.matmul import matmul_unicast, matmul_unicast_plain

fault = sys.argv[1]
lib = s._build.load("matmul_unicast")
gen = torch.Generator(device="cuda").manual_seed(0)
for m, k, n, logits in s.SCHEDULE_SHAPES:
    if logits:
        a = torch.randn(m, k, device="cuda", generator=gen) * 4
        b = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(torch.bfloat16).t()
    else:
        a = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        b = (torch.randn(k, n, device="cuda", generator=gen) / math.sqrt(k)).to(torch.bfloat16)
    got, want = matmul_unicast(a, b).float(), matmul_unicast_plain(a, b).float()
    torch.cuda.synchronize()
    tol = s.TOL_FP32 if a.dtype == torch.float32 else s.TOL_BF16
    ratio = float(((got - want).abs() / (tol + tol * want.abs())).max())
    ok = bool(torch.isfinite(got).all()) and ratio <= 1
    print(json.dumps(dict(fault=fault, shape=[m, k, n], design=matmul_unicast.design,
                          splits=lib.matmul_unicast_splits(n, k),
                          verdict="passes" if ok else "fails", err_over_allowance=ratio)),
          flush=True)
'''


def main() -> int:
    wrong = []
    for fault, (line, broken, touches) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            text = (copy / SOURCE).read_text()
            if text.count(line) != 1:
                sys.exit(f"{SOURCE}: expected the line {line!r} once")
            (copy / SOURCE).write_text(text.replace(line, broken))
            run = subprocess.run([sys.executable, "-c", CHECK, fault], cwd=copy, check=True,
                                 capture_output=True, text=True)
        for rec in map(json.loads, run.stdout.splitlines()):
            print(json.dumps(rec), flush=True)
            touched = touches(rec["design"], rec["splits"])
            caught = rec["verdict"] == "fails" and rec["err_over_allowance"] >= CATCH
            if touched != caught or (not touched and rec["verdict"] != "passes"):
                wrong.append((fault, rec["shape"], rec["verdict"], rec["err_over_allowance"]))
    print(json.dumps({"faults": len(FAULTS), "unexpected": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
