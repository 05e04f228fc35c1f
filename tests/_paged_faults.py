"""Planted faults in the paged-attention kernels K2 and K3
(``csrc/paged_attention_decode.cu``, ``csrc/paged_attention_prefill.cu``),
to show that ``chip_smoke.py``'s paged checks catch them at its rows.

    python3 tests/_paged_faults.py

from the root of a checkout, on a machine with one CUDA card.  For each
fault it copies ``src/`` and ``chip_smoke.py`` into a temporary
directory, edits one line of one kernel source there (the checkout is
never touched), builds the copy's kernel and runs it against its plain
version at every row of ``chip_smoke.DECODE_ROWS`` or ``PREFILL_ROWS``
(the same inputs, from ``chip_smoke.decode_case`` / ``prefill_case``),
twice in a row, judged as ``chip_smoke.check_close`` judges it:
|got - want| <= tol (1 + |want|), tol 2e-2 for bf16 outputs and 1e-4 for
fp32.  Outputs are allocated over NaN-filled memory, so an element no CTA
writes fails.  The faults run in parallel, one process each.  One JSON
line per (fault, row) gives the design that ran, its split count, the
verdict and the worst error over its allowance of the two calls (> 1
fails).

A fault must fail every row it touches by at least 10x and every other
row must pass; the script exits 1 otherwise.
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
KERNEL = {"paged_attention_decode.cu": "paged_attention_decode",
          "paged_attention_prefill.cu": "paged_attention_prefill"}


def split_kv(row, design, splits):
    return design == "split-kv" and splits > 1


def multi_row_wgmma(row, design, splits):
    """K3's tensor-core design on a row whose queries do not all see every
    key: a single-token row (``*-decode``, s = 1 at the sequence's end)
    sees every key below its length whatever its causal bound or offset."""
    return design == "wgmma" and not row.endswith("-decode")


# name -> (source, the line as written, the line with the fault, the
# (row label, design, split count) runs it touches)
FAULTS = {
    # the last CTA's merge weighs split 0's partial by 0
    "K2: one split's partial left out of the merge": (
        "paged_attention_decode.cu",
        "const float f = expf(fac[j * group + g] - mx);",
        "const float f = j == 0 ? 0.f : expf(fac[j * group + g] - mx);",
        split_kv),
    # each split stops one page short of its run
    "K2: the last page of a split not walked": (
        "paged_attention_decode.cu",
        "const int p0 = min(n_pages, split * pps), p1 = min(n_pages, p0 + pps);",
        "const int p0 = min(n_pages, split * pps), p1 = min(n_pages, p0 + pps - 1);",
        split_kv),
    # the counter stays at `splits` after a launch: the second call's CTAs
    # never see themselves last, and no output is written
    "K2: the counter not reset": (
        "paged_attention_decode.cu",
        "if (threadIdx.x == 0) *counter = 0;  // ready for the next launch",
        "if (false) *counter = 0;",
        split_kv),
    # keys past a row's position are not masked
    "K3: the causal bound dropped": (
        "paged_attention_prefill.cu",
        "sc[j] = (kpos < length && kpos <= qpos[hi]) ? x : NEG_INF;",
        "sc[j] = (kpos < length) ? x : NEG_INF;",
        multi_row_wgmma),
    # int8 pools: K dequantised with V's scales
    "K3: the V scale applied to K": (
        "paged_attention_prefill.cu",
        "dequant8(kr8 + r * D + ch * 8, __bfloat162float(ksr[r]));",
        "dequant8(kr8 + r * D + ch * 8, __bfloat162float(vsr[r]));",
        lambda row, design, splits: design == "wgmma" and row.startswith("int8")),
    # every row of a chunk placed one token late: it sees one key more
    "K3: a chunk's row offset one token off": (
        "paged_attention_prefill.cu",
        "const int q0 = start[b] + t0;",
        "const int q0 = start[b] + t0 + 1;",
        multi_row_wgmma),
}
CATCH = 10.0  # a touched run fails by at least this much

CHECK = r'''
import json, math, sys, torch
import chip_smoke as s
from repro_torch.kernels import KERNELS

fault, name = sys.argv[1], sys.argv[2]
s._build.build_all([name])
decode = name == "paged_attention_decode"
fn = KERNELS[name]
for label, kw in (s.DECODE_ROWS if decode else s.PREFILL_ROWS):
    kw = {k: v for k, v in kw.items() if k != "runs"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if decode:
        q, kp, vp, table, start, lengths = s.decode_case(gen, **kw)
        run = lambda: fn(q, kp, vp, table, start, lengths)
        want = s.paged_attention_decode_plain(q, kp, vp, table, start, lengths).float()
    else:
        q, kp, vp, table, start, lengths, extra = s.prefill_case(gen, **kw)
        run = lambda: fn(q, kp, vp, table, start, lengths, **extra)
        want = s.paged_attention_prefill_plain(q, kp, vp, table, start, lengths,
                                               **extra).float()
    tol = s.TOL_FP32 if q.dtype == torch.float32 else s.TOL_BF16
    worst = 0.0
    for _ in range(2):  # a second call shows state one launch leaves for the next
        torch.full(q.shape, float("nan"), dtype=q.dtype, device="cuda")  # freed: run's output
        got = run().float()
        torch.cuda.synchronize()
        ratio = torch.nan_to_num((got - want).abs() / (tol + tol * want.abs()), nan=math.inf)
        worst = max(worst, float(ratio.max()))
    kvh, _, ps, d = kp.shape
    code, width = s._DTYPE_CODES[q.dtype], table.shape[1]
    if decode:
        splits = s._decode_splits(code, q.shape[0], kvh, ps, d, width)
    else:
        b, sq, h = q.shape[:3]
        splits = s._prefill_splits(code, s._DTYPE_CODES[kp.dtype], b, sq,
                                   s.prefill_chunk(sq, h // kvh), h, kvh, ps, d, width)
    print(json.dumps(dict(fault=fault, kernel=name, row=label, design=fn.design,
                          splits=splits, verdict="passes" if worst <= 1 else "fails",
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
                [sys.executable, "-c", CHECK, fault, KERNEL[source]], cwd=copy,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fault, proc in runs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"{fault}: the check failed to run:\n{err[-4000:]}")
            touches = FAULTS[fault][3]
            for rec in map(json.loads, out.splitlines()):
                print(json.dumps(rec), flush=True)
                touched = touches(rec["row"], rec["design"], rec["splits"])
                caught = rec["verdict"] == "fails" and rec["err_over_allowance"] >= CATCH
                if touched != caught or (not touched and rec["verdict"] != "passes"):
                    wrong.append((fault, rec["kernel"], rec["row"], rec["verdict"],
                                  rec["err_over_allowance"]))
    print(json.dumps({"faults": len(FAULTS), "unexpected": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
