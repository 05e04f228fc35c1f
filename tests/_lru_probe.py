"""Where K11's and K12's time goes at recurrentgemma-2b's width.

    python3 tests/_lru_probe.py

from the root of a checkout, on a machine with one CUDA card.  It prints
the card line and then one JSON line each for:

* ``copy``: the bandwidth yardstick — one device-to-device copy
  (``Tensor.copy_``) that reads and writes as many bytes as K11 moves
  (12 a step a channel) and one for K12's 20, timed as the kernels are
  (``chip_smoke.time_ms``: L2 flushed before each run, median);
* each variant of the RG-LRU sources — ``src/`` and ``chip_smoke.py``
  copied into a temporary directory and a line or two edited there, the
  checkout never touched — with the median ms of one K11 and one K12
  call and each output's err_over_allowance against the plain versions
  at ``TOL_SCAN``, at ``chip_smoke.LRU_SHAPES``' full-width rows:
  "as built"; "no peek" (every tile but the first walks twice and looks
  back, even when its predecessor's prefix is out); "no look-back wait"
  (the carry is taken as 0 where the tile would look back: loads, walks,
  stores and publishing without waiting); "loads and stores" (no walk
  and no look-back: each tile copies b, or dh, to its output); "T = 32";
  "W = 64"; "T = 128, W = 64" (the chunk and the tile's channels, as
  built 64 and 128).  The outputs of "no look-back wait" and "loads and
  stores" are wrong by construction.
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
WRAPPER = "src/repro_torch/kernels/rglru/rglru.py"


def _sizes(t: int, w: int) -> list:
    """The chunk and the tile width, in the kernels and in the wrapper."""
    return [(CSRC + "rglru_common.cuh", "constexpr int T = 64;", f"constexpr int T = {t};"),
            (CSRC + "rglru_common.cuh", "constexpr int W = 128;", f"constexpr int W = {w};"),
            (WRAPPER, "RGLRU_CHUNK = 64", f"RGLRU_CHUNK = {t}"),
            (WRAPPER, "RGLRU_WIDTH = 128", f"RGLRU_WIDTH = {w}")]


# variant -> edits: (file, text, replacement), every occurrence replaced
VARIANTS = {
    "as built": [],
    "no peek": [(CSRC + f, "const bool walked = t.pos == 0 || peek(sc, t, carry);",
                 "const bool walked = t.pos == 0;")
                for f in ("rglru_scan_fwd.cu", "rglru_scan_bwd.cu")],
    "no look-back wait": [(CSRC + f, "carry = look_back(sc, t);", "carry = 0.f;")
                          for f in ("rglru_scan_fwd.cu", "rglru_scan_bwd.cu")],
    "loads and stores": [
        (CSRC + "rglru_scan_fwd.cu", "const bool walked = t.pos == 0 || peek(sc, t, carry);",
         "const bool walked = true;"),
        (CSRC + "rglru_scan_fwd.cu", "state = __fadd_rn(__fmul_rn(sa[r * W], state), sb[r * W]);",
         "state = sb[r * W];"),
        (CSRC + "rglru_scan_bwd.cu", "const bool walked = t.pos == 0 || peek(sc, t, carry);",
         "const bool walked = true;"),
        (CSRC + "rglru_scan_bwd.cu", "const float g = __fadd_rn(sg[r * W], carry);",
         "const float g = sg[r * W];")],
    "T = 32": _sizes(32, 128),
    "W = 64": _sizes(64, 64),
    "T = 128, W = 64": _sizes(128, 64),
}

RUN = r'''
import json, sys, torch
import chip_smoke as s

variant = sys.argv[1]
s._build.build_all(["rglru_scan", "rglru_scan_bwd"])


def ratio(got, want):
    return float(s.flash_ratios(got, want, s.TOL_SCAN).max())


rec = dict(variant=variant, ms={}, err_over_allowance={})
for c in s.LRU_SHAPES:
    if c.b * c.s * c.d < 1 << 23:  # the full-width rows
        continue
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, x, dh = s._lru_inputs(gen, c)
    h_p = s.rglru_scan_plain(a, x)
    h_prev = torch.nn.functional.pad(h_p[:, :-1], (0, 0, 1, 0))
    h, (da, db) = s.rglru_scan(a, x), s.rglru_scan_bwd(a, h_prev, dh)
    da_p, db_p = s.rglru_scan_bwd_plain(a, h_prev, dh)
    torch.cuda.synchronize()
    rec["err_over_allowance"][c.label] = dict(h=ratio(h, h_p), da=ratio(da, da_p),
                                              db=ratio(db, db_p))
    rec["ms"][c.label] = dict(
        rglru_scan=s.time_ms(lambda: s.rglru_scan(a, x), 25)[0],
        rglru_scan_bwd=s.time_ms(lambda: s.rglru_scan_bwd(a, h_prev, dh), 25)[0])
print(json.dumps(rec), flush=True)
'''

COPY = r'''
import json, torch
import chip_smoke as s

rec = dict(check="copy", ms={})
for c in s.LRU_SHAPES:
    if c.b * c.s * c.d < 1 << 23:  # the full-width rows
        continue
    n = c.b * c.s * c.d
    ms = {}
    for name, step_bytes in (("rglru_scan", 12), ("rglru_scan_bwd", 20)):
        src = torch.empty(n * step_bytes // 8, dtype=torch.float32, device="cuda")
        dst = torch.empty_like(src)
        t = s.time_ms(lambda: dst.copy_(src), 25)[0]
        ms[name] = dict(ms=t, bytes=n * step_bytes, tb_per_s=n * step_bytes / t / 1e9)
    rec["ms"][c.label] = ms
print(json.dumps(rec), flush=True)
'''


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    subprocess.run([sys.executable, "-c", COPY], cwd=ROOT, check=True)
    for variant, edits in VARIANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            for source, line, changed in edits:
                text = (copy / source).read_text()
                if line not in text:
                    sys.exit(f"{source}: expected the line {line!r}")
                (copy / source).write_text(text.replace(line, changed))
            subprocess.run([sys.executable, "-c", RUN, variant], cwd=copy, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
