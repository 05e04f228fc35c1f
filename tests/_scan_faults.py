"""Planted faults in the scan kernels, to show that ``chip_smoke.py``'s
K9-K12 checks catch them.

    python3 tests/_scan_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one line of a kernel source there (the checkout is
never touched), builds the kernels of the copy and runs K9 and K10 at
mamba2-780m's full width and the ragged SSD cell, K11 and K12 at
recurrentgemma-2b's full width and the ragged RG-LRU cell, each against
its plain version.  Each output is judged by ``chip_smoke.check_flash_close``
at ``TOL_SCAN`` (1e-4 x (|want| + the RMS of want's row)); one JSON line
per (fault, cell, output) gives the verdict and the worst error over its
allowance (> 1 fails).  K10 is fed the plain version's states, so a fault
in K9 stays in K9.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/csrc")

# name -> (source, the line as written, the line with the fault)
FAULTS = {
    "K9 skips the inter-chunk term of the middle chunk": (
        CSRC / "ssd_scan_fwd.cu",
        "const float out = acc + expf(ls[i]) * yi[a];",
        "const float out = acc + (ci == nc / 2 ? 0.f : expf(ls[i]) * yi[a]);"),
    "K10 drops term (c) of d log a": (
        CSRC / "ssd_scan_bwd.cu",
        "const float total = ta[tid] + suffix_u + prefix_r + expf(ltot) * d_all;",
        "const float total = ta[tid] + suffix_u + expf(ltot) * d_all;"),
    "K12 drops the carry out of one thread's first step": (
        CSRC / "rglru_scan_bwd.cu",
        "carry = __fmul_rn(av[u], g);",
        "carry = (blockIdx.y == 0 && ch == 0 && t == s && u == 0) ? 0.f : __fmul_rn(av[u], g);"),
}

CHECK = r'''
import json, sys, torch
import chip_smoke as s

fault = sys.argv[1]


def judge(case, name, got, want):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    diff, allow = (g - w).abs(), s.flash_atol(w, s.TOL_SCAN) + s.TOL_SCAN * w.abs()
    rec = dict(fault=fault, case=case, output=name,
               err_over_allowance=float(torch.where(diff > 0, diff / allow, 0.0).max()),
               finite=bool(torch.isfinite(g).all()))
    try:
        rec["max_abs_err"] = s.check_flash_close(name, got, want, s.TOL_SCAN)[0]
        rec["verdict"] = "passes"
    except AssertionError:
        rec["verdict"] = "fails"
    print(json.dumps(rec), flush=True)


for c in (s.SSD_SHAPES[0], s.SSD_SHAPES[2]):
    gen = torch.Generator(device="cuda").manual_seed(0)
    xdt, bm, cm, log_a, dy = s._ssd_inputs(gen, c)
    lcum = s.ssd_lcum(log_a, s.SSD_CHUNK)
    y, st = s.ssd_scan(xdt, bm, cm, lcum, return_states=True)
    y_p, st_p = s.ssd_scan_plain(xdt, bm, cm, lcum, return_states=True)
    judge(c.label, "y", y, y_p)
    judge(c.label, "states", st, st_p)
    bwd = (xdt, bm, cm, lcum, st_p, dy)
    got, want = s.ssd_scan_bwd(*bwd), s.ssd_scan_bwd_plain(*bwd)
    for name, g, w in zip(("dx", "db", "dc"), got, want):
        judge(c.label, name, g, w)
    judge(c.label, "dl", got[3][..., 0], want[3][..., 0])
    del got, want, st, st_p
for c in (s.LRU_SHAPES[0], s.LRU_SHAPES[2]):
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, x, dh = s._lru_inputs(gen, c)
    h_p = s.rglru_scan_plain(a, x)
    judge(c.label, "h", s.rglru_scan(a, x), h_p)
    h_prev = torch.nn.functional.pad(h_p[:, :-1], (0, 0, 1, 0))
    (da, db), (da_p, db_p) = s.rglru_scan_bwd(a, h_prev, dh), s.rglru_scan_bwd_plain(a, h_prev, dh)
    judge(c.label, "da", da, da_p)
    judge(c.label, "db", db, db_p)
'''


def main() -> int:
    for fault, (source, line, broken) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            text = (copy / source).read_text()
            if text.count(line) != 1:
                sys.exit(f"{source}: expected the line {line!r} once")
            (copy / source).write_text(text.replace(line, broken))
            subprocess.run([sys.executable, "-c", CHECK, fault], cwd=copy, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
