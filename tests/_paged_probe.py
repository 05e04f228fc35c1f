"""Where K2's split-kv time goes at long contexts: loads or arithmetic.

    python3 tests/_paged_probe.py

from the root of a checkout, on a machine with one CUDA card.  It copies
``src/`` and ``chip_smoke.py`` into a temporary directory three times
(the checkout is never touched) and builds ``csrc/paged_attention_decode.cu``
as written, with each page's arithmetic skipped (the pages are still
copied into the ring: "loads only") and with the page copies skipped (the
arithmetic runs on whatever the ring holds: "arithmetic only"), then times
each on the K2 rows of ``chip_smoke.DECODE_ROWS`` with ``chip_smoke.time_ms``
after its usual flush (which leaves L2 full of dirty lines) and after a
flush that leaves L2 clean.  The variants' outputs are wrong by
construction and are not checked; the unmodified kernel's are.  One JSON
line per variant: per row, [ms, ms with L2 clean, GB/s of the row's K/V
bytes at the clean time].
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/csrc/paged_attention_decode.cu")
VARIANTS = {
    "as written": [],
    "loads only": [("""      const int kbase = (wp0 + i * SK_WARPS) * PS;
""", """      const int kbase = (wp0 + i * SK_WARPS) * PS;
      if (length > 0) {
        __syncwarp();
        if (lane == 0 && i + stages < cnt) {
          fence_async_smem();
          issue(u + stages, i + stages);
        }
        continue;
      }
""")],
    "arithmetic only": [("""    bulk_load(dst, kp + page * PAGE, PAGE * sizeof(bf16), &full[st]);
    bulk_load(dst + PAGE, vp + page * PAGE, PAGE * sizeof(bf16), &full[st]);
""", """    (void)dst;
    (void)page;
"""), ("""    bar_expect_tx(&full[st], 2 * PAGE * sizeof(bf16));
""", """    bar_arrive(&full[st]);
""")],
}

RUN = r'''
import json, sys, torch
import chip_smoke as s
from repro_torch.kernels.paged_attention import paged_attention_decode as dec
variant = sys.argv[1]
s._build.build_all(["paged_attention_decode"])
out = {}
for label, kw in s.DECODE_ROWS:
    kw = {k: v for k, v in kw.items() if k != "runs"}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, kp, vp, table, start, lengths = s.decode_case(gen, **kw)
    run = lambda: dec(q, kp, vp, table, start, lengths)
    if variant == "as written":
        want = s.paged_attention_decode_plain(q, kp, vp, table, start, lengths)
        s.check_close(label, run(), want, s.TOL_FP32 if q.dtype == torch.float32 else s.TOL_BF16)
    nbytes, _ = s._attn_work(start, lengths, 1, kp.shape[2], kp.shape[0], q.shape[1],
                             q.shape[2], kp.element_size())
    ms, clean = s.time_ms(run, runs=10)[0], s.time_ms(run, runs=10, clean_l2=True)[0]
    out[label] = [ms, clean, nbytes / clean / 1e6]
print(json.dumps(dict(variant=variant, design=dec.design, rows=out)), flush=True)
'''


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        for i, (variant, edits) in enumerate(VARIANTS.items()):
            copy = Path(tmp) / str(i)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy)
            text = (copy / SOURCE).read_text()
            for line, edited in edits:
                if text.count(line) != 1:
                    sys.exit(f"{SOURCE}: expected {line!r} once")
                text = text.replace(line, edited)
            (copy / SOURCE).write_text(text)
            copies[variant] = copy
        builds = [subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
             "from repro_torch.kernels import _build; _build.build_all(['paged_attention_decode'])"],
            cwd=copy) for copy in copies.values()]
        if any([b.wait() != 0 for b in builds]):  # wait for every build
            sys.exit("a variant failed to build")
        for variant, copy in copies.items():  # timed one at a time
            proc = subprocess.run([sys.executable, "-c", RUN, variant], cwd=copy,
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"{variant}:\n{proc.stderr[-4000:]}")
            print(proc.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
