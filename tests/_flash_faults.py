"""Planted faults in the flash-attention kernels, to show that
``chip_smoke.py``'s K6-K8 checks catch them at the two full-width shapes.

    python3 tests/_flash_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one line of a kernel source there (the checkout is
never touched), builds the kernels of the copy and runs K6, K7 and K8
against their plain versions at qwen1.5-0.5b's and gemma2-9b's local
layers' shapes (bf16: all three run their wgmma design).  Each output is
judged as ``chip_smoke.check_flash_close`` judges it (rows that see one
key, and keys fed only by such rows, held to their rounding bound), in
two forms: a fixed 2e-2 absolute term, and the row-RMS term the checks
use.  One JSON line per (fault, shape, output, form) gives the
verdict and the worst error over its allowance (> 1 fails).  K7 and K8
are fed the plain version's lse, so a fault in K6 stays in K6.

A fault must fail every output it touches by at least 10x under the
row-RMS form, and every other output must pass; the script exits 1
otherwise.
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
QWEN, GEMMA = "qwen1.5-0.5b", "gemma2-9b local layer"
ALL = ("o", "dq", "dk", "dv")

# name -> (source, the line as written, the line with the fault,
#          {shape: the outputs the fault touches})
FAULTS = {
    # the mask every masked tile of K6, K7 (both designs) and K8 applies
    "window one key too wide": (
        CSRC / "flash_common.cuh", "q - k >= window", "q - k > window", {GEMMA: ALL}),
    # the bf16 K6's kv-tile walk, shared by its producer and consumers
    "first kv tile skipped from row 1024 (K6)": (
        CSRC / "flash_attention_fwd.cu",
        "const int t0 = lo / BK, t1 = (hi + BK - 1) / BK;",
        "const int t0 = lo / BK + (q0 >= 1024), t1 = (hi + BK - 1) / BK;",
        {QWEN: ("o",), GEMMA: ("o",)}),
    # the bf16 K7's dS: p (dP - delta) becomes p dP
    "delta dropped from dS (K7)": (
        CSRC / "flash_attention_bwd_dq.cu", "* (dp - delta);", "* dp;",
        {QWEN: ("dq",), GEMMA: ("dq",)}),
    # the bf16 K8's dS^T: p (dP - delta) becomes p dP
    "delta dropped from dS (K8)": (
        CSRC / "flash_attention_bwd_dkv.cu", "float ds = pv * (dpt[j] - delta_t[c]);",
        "float ds = pv * dpt[j];", {QWEN: ("dk",), GEMMA: ("dk",)}),
    # the bf16 K8's query walk, shared by its loads and its products
    "first query tile skipped (K8)": (
        CSRC / "flash_attention_bwd_dkv.cu",
        "const int t0 = lo / BQ, tiles = (hi + BQ - 1) / BQ - t0;",
        "const int t0 = lo / BQ + 1, tiles = (hi + BQ - 1) / BQ - t0;",
        {QWEN: ("dk", "dv"), GEMMA: ("dk", "dv")}),
}
CATCH = 10.0  # a touched output fails by at least this much

CHECK = r'''
import json, sys, torch
import chip_smoke as s

fault = sys.argv[1]
s._build.build_all()
forms = (("2e-2 fixed", lambda want, tol: tol), ("row rms", s.flash_atol))
for c in s.FLASH_SHAPES[:2]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = s._flash_inputs(gen, c)
    kw = dict(causal=c.causal, window=c.window, softcap=c.softcap)
    o, lse = s.flash_attention(q, k, v, return_lse=True, **kw)
    o_p, lse_p = s.flash_attention_plain(q, k, v, return_lse=True, **kw)
    bwd = (q, k, v, do, lse_p, (do.float() * o_p.float()).sum(-1))
    (dk, dv), (dk_p, dv_p) = s.flash_attention_bwd_dkv(*bwd, **kw), \
        s.flash_attention_bwd_dkv_plain(*bwd, **kw)
    outs = {"o": (o, o_p),
            "dq": (s.flash_attention_bwd_dq(*bwd, **kw),
                   s.flash_attention_bwd_dq_plain(*bwd, **kw)),
            "dk": (dk, dk_p), "dv": (dv, dv_p)}
    rounding = s.single_key_rounding(c, q, k, v, do)
    rules = {"dq": rounding["dq"], "dk": rounding["dk"]}
    designs = {n: s.kernels.KERNELS[n].design for n in s.FLASH_KERNELS}
    try:
        s.check_close("lse", lse, lse_p, s.TOL_FP32)
        lse_ok = True
    except AssertionError:
        lse_ok = False
    for name, (got, want) in outs.items():
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        for form, atol in forms:
            ratio = float(s.flash_ratios(g, w, s.TOL_BF16, rules.get(name), atol).max())
            ok = bool(torch.isfinite(g).all()) and ratio <= 1
            print(json.dumps(dict(fault=fault, case=c.label, output=name, form=form,
                                  verdict="passes" if ok else "fails", err_over_allowance=ratio,
                                  max_abs_err=float(diff.max()), lse_passes=lse_ok,
                                  designs=designs)), flush=True)
    del outs, dk, dv, dk_p, dv_p, o_p, lse_p
    torch.cuda.empty_cache()
'''


def main() -> int:
    wrong = []
    for fault, (source, line, broken, touches) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            text = (copy / source).read_text()
            if text.count(line) != 1:
                sys.exit(f"{source}: expected the line {line!r} once")
            (copy / source).write_text(text.replace(line, broken))
            run = subprocess.run([sys.executable, "-c", CHECK, fault], cwd=copy, check=True,
                                 capture_output=True, text=True)
        for rec in map(json.loads, run.stdout.splitlines()):
            print(json.dumps(rec), flush=True)
            if rec["form"] != "row rms":
                continue
            touched = rec["output"] in touches.get(rec["case"], ())
            caught = rec["verdict"] == "fails" and rec["err_over_allowance"] >= CATCH
            if touched != caught or (not touched and rec["verdict"] != "passes"):
                wrong.append((fault, rec["case"], rec["output"], rec["verdict"],
                              rec["err_over_allowance"]))
    print(json.dumps({"faults": len(FAULTS), "unexpected": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
