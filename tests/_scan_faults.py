"""Planted faults in the scan kernels, to show that ``chip_smoke.py``'s
K9-K12 checks catch them.

    python3 tests/_scan_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one or two lines of the kernel sources there (the
checkout is never touched), builds the kernels of the copy and runs K9 and K10 at
mamba2-780m's full width and the ragged SSD cell (s = 200, a short last
chunk), K11 and K12 at recurrentgemma-2b's full width and the ragged
RG-LRU cell (s = 77: two of the kernels' 64-step chunks, the last of 13),
each against its plain version.  Each output is judged by
``chip_smoke.check_flash_close`` at ``TOL_SCAN`` (1e-4 x (|want| + the RMS
of want's row)); one JSON line per (fault, cell, output) gives the
verdict and the worst error over its allowance (> 1 fails).  K10 is fed
the plain version's states and K12 the plain version's h, so a fault in
K9 or K11 stays there.

Each fault must fail every output it touches — the structural ones by
an err_over_allowance >= 10, the one TF32 pass by > 1 — in both SSD (or
both RG-LRU) cells, and every other output must pass; else the script
exits 1.
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
SSD_OUTPUTS = ("y", "states", "dx", "db", "dc", "dl")
LRU_OUTPUTS = ("h", "da", "db")

# the three products of one k-step in ssd_common.cuh's gemm
THREE_PASSES = """        mma0(part, as[i], bb[j]);
        mma(part, ab[i], bs[j]);
        mma(part, ab[i], bb[j]);
"""
# name -> (edits: (source, the lines as written, the lines with the fault),
# the family and outputs it touches, the least err_over_allowance it must show)
FAULTS = {
    "K9's state pass drops F_c of the middle chunk": (
        [(CSRC / "ssd_scan_fwd.cu",
          "for (int k = 0; k < V; ++k) h.v[k] = fmaf(a[u], h.v[k], f[u].v[k]);",
          "for (int k = 0; k < V; ++k) h.v[k] = fmaf(a[u], h.v[k], c == nc / 2 ? 0.f : f[u].v[k]);")],
        "ssd", ("y", "states"), 10.0),
    "K10's reverse pass leaves out E_c+1 for one chunk": (
        [(CSRC / "ssd_scan_bwd.cu",
          "for (int k = 0; k < V; ++k) g.v[k] = fmaf(a[u], g.v[k], f[u].v[k]);",
          "for (int k = 0; k < V; ++k) g.v[k] = fmaf(a[u], g.v[k], c == nc / 2 ? 0.f : f[u].v[k]);")],
        "ssd", ("dx", "db", "dl"), 10.0),
    "K10 drops term (c) of d log a": (
        [(CSRC / "ssd_scan_bwd.cu",
          "const float c1 = warp_prefix(r0 + r1) - r1, c0 = c1 - r0;",
          "const float c1 = 0.f, c0 = 0.f;")],
        "ssd", ("dl",), 10.0),
    # the two correction terms dropped where K9 is compiled (K9_ONE_PASS
    # is defined in ssd_scan_fwd.cu only, so K10 keeps 3xTF32)
    "K9's products in one TF32 pass": (
        [(CSRC / "ssd_common.cuh", THREE_PASSES,
          "#ifdef K9_ONE_PASS\n        mma0(part, ab[i], bb[j]);\n#else\n" + THREE_PASSES
          + "#endif\n"),
         (CSRC / "ssd_scan_fwd.cu", '#include "ssd_common.cuh"',
          '#define K9_ONE_PASS\n#include "ssd_common.cuh"')],
        "ssd", ("y", "states"), 1.0),
    "K12 drops the carry out of one channel's last step": (
        [(CSRC / "rglru_scan_bwd.cu",
          "carry = __fmul_rn(sa[r * W], g);",
          "carry = t.batch == 0 && t.ch0 + threadIdx.x == 0 && t0 + r == s - 1 ? 0.f"
          " : __fmul_rn(sa[r * W], g);")],
        "rglru", ("da", "db"), 10.0),
    # the middle chunk of batch 0's first channel block walks from 0
    "K11 drops one tile's carry-in": (
        [(CSRC / "rglru_scan_fwd.cu",
          "float state = carry;",
          "float state = t.col == 0 && t.pos == (int)(gridDim.x / cols) / 2 ? 0.f : carry;")],
        "rglru", ("h",), 10.0),
    # g_t = dh_t + a_t g_{t+1}: each step's carry decayed by the a of the
    # step walked next
    "K12 composes its carry with a_t in place of a_{t+1}": (
        [(CSRC / "rglru_scan_bwd.cu",
          "carry = __fmul_rn(sa[r * W], g);",
          "carry = __fmul_rn(sa[(r > 0 ? r - 1 : r) * W], g);")],
        "rglru", ("da", "db"), 10.0),
}

CHECK = r'''
import json, sys, torch
import chip_smoke as s

fault = sys.argv[1]


def judge(family, case, name, got, want):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    diff, allow = (g - w).abs(), s.flash_atol(w, s.TOL_SCAN) + s.TOL_SCAN * w.abs()
    rec = dict(fault=fault, family=family, case=case, output=name,
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
    judge("ssd", c.label, "y", y, y_p)
    judge("ssd", c.label, "states", st, st_p)
    bwd = (xdt, bm, cm, lcum, st_p, dy)
    got, want = s.ssd_scan_bwd(*bwd), s.ssd_scan_bwd_plain(*bwd)
    for name, g, w in zip(("dx", "db", "dc"), got, want):
        judge("ssd", c.label, name, g, w)
    judge("ssd", c.label, "dl", got[3][..., 0], want[3][..., 0])
    del got, want, st, st_p
for c in (s.LRU_SHAPES[0], next(c for c in s.LRU_SHAPES if c.label == "ragged")):
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, x, dh = s._lru_inputs(gen, c)
    h_p = s.rglru_scan_plain(a, x)
    judge("rglru", c.label, "h", s.rglru_scan(a, x), h_p)
    h_prev = torch.nn.functional.pad(h_p[:, :-1], (0, 0, 1, 0))
    (da, db), (da_p, db_p) = s.rglru_scan_bwd(a, h_prev, dh), s.rglru_scan_bwd_plain(a, h_prev, dh)
    judge("rglru", c.label, "da", da, da_p)
    judge("rglru", c.label, "db", db, db_p)
'''


def expected(records, family, touched, least) -> list[str]:
    """What departs from the fault's expectation: a touched output that
    passes or fails by less than ``least``, an untouched one that fails."""
    wrong = []
    for rec in records:
        hit = rec["family"] == family and rec["output"] in touched
        ratio = rec["err_over_allowance"] if rec["finite"] else float("inf")
        if hit and not (rec["verdict"] == "fails" and ratio >= least and ratio > 1):
            wrong.append(f"{rec['case']} {rec['output']}: {rec['verdict']} at {ratio:.3g}, "
                         f"expected to fail by >= {least}")
        if not hit and rec["verdict"] != "passes":
            wrong.append(f"{rec['case']} {rec['output']}: fails at {ratio:.3g}, untouched")
    return wrong


def main() -> int:
    missed = {}
    for fault, (edits, family, touched, least) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            for source, line, broken in edits:
                text = (copy / source).read_text()
                if text.count(line) != 1:
                    sys.exit(f"{source}: expected the line {line!r} once")
                (copy / source).write_text(text.replace(line, broken))
            out = subprocess.run([sys.executable, "-c", CHECK, fault], cwd=copy, check=True,
                                 capture_output=True, text=True).stdout
        records = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        for rec in records:
            print(json.dumps(rec), flush=True)
        outputs = {"ssd": SSD_OUTPUTS, "rglru": LRU_OUTPUTS}
        if len(records) != 2 * (len(SSD_OUTPUTS) + len(LRU_OUTPUTS)) or any(
                r["output"] not in outputs[r["family"]] for r in records):
            sys.exit(f"{fault}: unexpected records")
        missed[fault] = expected(records, family, touched, least)
        print(json.dumps(dict(fault=fault, as_expected=not missed[fault],
                              departures=missed[fault])), flush=True)
    return 1 if any(missed.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
