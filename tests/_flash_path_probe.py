"""The phase-2b flash path at gemma2-9b's local layer on the card, on a
second draw: the one it gets when every row of ``DECODE_ROWS`` and
``PREFILL_ROWS`` draws from ``chip_smoke.py``'s shared generator
(``chip_smoke.py`` itself draws the ``FAMILY_PAGED`` rows from a generator
of their own).  It holds dK and dV of K8 through autograd to the plain
versions at phase 2b's allowance, and the kernel and the plain version
to an fp64 autograd reference (``flash_fp64_grads``).

    python3 tests/_flash_path_probe.py

from the repository root on a machine with one CUDA card (about 3 min).
It replays phase 2's checks first, in that order, so that the shared
generator reaches the path with the same state; it prints one JSON line
per measurement and exits 0 (a probe: it gates nothing).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def replay_phase2(gen) -> None:
    """Phase 2's draws up to the flash path, in ``chip_smoke.main``'s order,
    every row on the shared generator."""
    for args, kw in (((4, 1024, 1024), {}),
                     ((4, 1024, 2816), dict(bias=False, activation="silu")),
                     ((4, 2816, 1024), dict(bias=False)),
                     ((48, 1024, 2816), dict(bias=False, activation="silu")),
                     ((4, 1024, 151936), dict(logits=True))):
        cs.check_matmul(gen, *args, **kw)
    for label, m, k, n, kw in cs.PAIR_MATMUL_ROWS:
        cs.check_matmul(gen, m, k, n, label=label, **kw)
    for m, k, n, logits in cs.SCHEDULE_SHAPES:
        cs.check_schedules(gen, m, k, n, logits=logits)
    for label, kw in cs.DECODE_ROWS:
        cs.check_decode(gen, label=label, **kw)
    for label, kw in cs.PREFILL_ROWS:
        cs.check_prefill(gen, label=label, **kw)
    for c in cs.FLASH_SHAPES:
        cs.check_flash(gen, c)
    cs.check_flash_path(gen, cs.FLASH_SHAPES[0])  # qwen's path draws first


def worst(got, want) -> tuple[float, list[int]]:
    """The largest |got - want| over the path check's allowance, and where."""
    ratio = cs.flash_ratios(got, want, cs.TOL_BF16)
    at = [int(x) for x in torch.nonzero(ratio == ratio.max())[0]]
    return float(ratio.max()), at


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs._build.build_all()
    cs.count_reference_calls()
    gen = torch.Generator(device="cuda").manual_seed(0)
    replay_phase2(gen)
    c = cs.FLASH_SHAPES[1]
    q, k, v, _ = cs._flash_inputs(gen, c)
    w = torch.randn(c.b, c.h, c.sq, c.d, device="cuda", generator=gen)
    do = w.to(c.dtype)
    fa = cs.kernels.op("flash_attention")
    kw = dict(causal=c.causal, window=c.window, softcap=c.softcap)

    def path():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad((fa(*leaves, **kw).float() * w).sum(), leaves)

    got = path()
    with cs.plain_versions():
        plain = path()
    ref = cs.flash_fp64_grads(c, q, k, v, do)
    for i, name in ((1, "dk"), (2, "dv")):
        bare, at = worst(got[i], plain[i])
        rec = dict(case=c.label, grad=name, kernel_vs_plain=bare, at=at,
                   kernel=float(got[i][tuple(at)]), plain=float(plain[i][tuple(at)]),
                   fp64=float(ref[i][tuple(at)]),
                   kernel_vs_fp64=worst(got[i], ref[i])[0], plain_vs_fp64=worst(plain[i], ref[i])[0])
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
