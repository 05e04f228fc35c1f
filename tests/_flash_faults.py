"""Planted faults in the flash-attention kernels, to show that
``chip_smoke.py``'s K6-K8 checks catch them at the two full-width shapes.

    python3 tests/_flash_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one line of a kernel source there (the checkout is
never touched), builds the kernels of the copy and runs K6, K7 and K8
against their plain versions at qwen1.5-0.5b's and gemma2-9b's local
layers' shapes.  Each output is judged by ``chip_smoke.check_flash_close``
in two forms: a fixed 2e-2 absolute term, and the row-RMS term the
checks use.  One JSON line per (fault, shape, output, form) gives the
verdict and the worst error over its allowance (> 1 fails).  K7 and K8
are fed the plain version's lse, so a fault in K6 stays in K6.
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
    "window one key too wide": (
        CSRC / "flash_common.cuh", "q - k >= window", "q - k > window"),
    "first kv tile skipped from row 1024 (K6)": (
        CSRC / "flash_attention_fwd.cu",
        "for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {",
        "for (int k0 = lo / BK * BK + (q0 >= 1024 ? BK : 0); k0 < hi; k0 += BK) {"),
}

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
    try:
        s.check_close("lse", lse, lse_p, s.TOL_FP32)
        lse_ok = True
    except AssertionError:
        lse_ok = False
    for name, (got, want) in outs.items():
        for form, atol in forms:
            s.flash_atol = atol
            rec = dict(fault=fault, case=c.label, output=name, form=form, lse_passes=lse_ok)
            try:
                rec["max_abs_err"], rec["err_over_allowance"], _ = s.check_flash_close(
                    name, got, want, s.TOL_BF16)
                rec["verdict"] = "passes"
            except AssertionError as e:
                rec["verdict"] = "fails: " + str(e).split(": ", 1)[1]
            print(json.dumps(rec), flush=True)
    del outs, dk, dv, dk_p, dv_p, o_p, lse_p
    torch.cuda.empty_cache()
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
