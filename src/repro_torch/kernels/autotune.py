"""The schedule-selection model of the JAX package's autotuner.

A copy of the part of ``repro.kernels.autotune`` that decides *which
schedule* a kernel call dispatches to: the candidate block
configurations of the matmul, paged-attention, flash-attention, SSD and
RG-LRU families, each with its modeled working set (``vmem_bytes``),
grid steps and HBM traffic, pruned to a budget and sorted best cost
first.  ``kernels.api`` reads
it through the availability predicates (some candidate fits the budget)
and the cost hooks (the best candidate's cost), so the port picks the
same schedule as the JAX package for every (shape, dtype, policy).

``VMEM_BUDGET`` is the JAX package's *dispatch rule* (three quarters of
a TPU core's 16 MiB VMEM), kept verbatim so the two packages agree.  It
is not a model of Hopper's shared memory: the CUDA kernels use fixed
tile sizes of their own, and the block configurations here only rank
schedules and decide availability.  The flash, SSD and RG-LRU families
are modelled for their cost alone: each has one schedule, always
available in the port (the CUDA kernels mask ragged edges and tile the
SSD state, so no block has to divide the sequence or fit VMEM).  The
JAX package's ``"bwd"`` candidates are not copied: they choose backward
blocks, and the port's backward kernels fix their own tiles.

Not copied: the measured timing sweep and the on-disk cache (ROADMAP
Queue 1 item 10) — the cost model alone decides, as it does in the JAX
package when no sweep has run.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Iterable, Sequence

import torch

VMEM_BYTES = 16 * 2**20  # per-core VMEM of the TPU the JAX package targets
VMEM_BUDGET = int(VMEM_BYTES * 0.75)
# Cost-model weight: one grid step "costs" this many equivalent HBM bytes
# of launch/pipeline overhead — breaks ties toward fewer, larger blocks.
STEP_OVERHEAD_BYTES = 8192

_ITEMSIZE = {"float32": 4, "bfloat16": 2}  # the kernels' input dtypes


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` or ``"bfloat16"`` -> ``"bfloat16"`` (the JAX
    package's dtype names, which key its problems)."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One block-size configuration plus its modeled resource usage."""

    config: tuple[tuple[str, int], ...]  # sorted (name, value) pairs
    vmem_bytes: int
    grid_steps: int
    hbm_bytes: float

    @property
    def cost(self) -> float:
        return self.hbm_bytes + STEP_OVERHEAD_BYTES * self.grid_steps


def _mk(config: dict[str, int], vmem: int, steps: int, hbm: float = 0.0) -> Candidate:
    return Candidate(tuple(sorted(config.items())), int(vmem), int(steps), float(hbm))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _divisors(total: int, options: Iterable[int]) -> list[int]:
    out = [o for o in options if o <= total and total % o == 0]
    return out or [total]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _clip(options: Iterable[int], limit: int, align: int = 128) -> list[int]:
    """Clip block options to the dimension extent, rounded up to
    ``align``; deduped, insertion-ordered."""
    seen: dict[int, None] = {}
    for o in options:
        seen[min(o, _round_up(limit, align))] = None
    return list(seen)


_MM_LANE = (128, 256, 512)  # bn/bk
_MM_SUB = (64, 128, 256, 512)  # bm
_GM_SUPER = (256, 512, 1024, 2048)


def _matmul_candidates(schedule: str, shape: Sequence[int], dsize: int) -> list[Candidate]:
    m, k, n = shape
    out = []
    if schedule == "mcast":
        for bn, bk in itertools.product(_clip(_MM_LANE, n), _clip(_MM_LANE, k)):
            # full-M A panel + acc/out panels resident; streams double-buffered
            vmem = 2 * (m * bk + bk * bn) * dsize + m * bn * (4 + dsize)
            steps = _cdiv(n, bn) * _cdiv(k, bk)
            hbm = (m * k * _cdiv(n, bn) + k * n + m * n) * dsize
            out.append(_mk({"bn": bn, "bk": bk}, vmem, steps, hbm))
    elif schedule == "tiled":
        for gm, bn, bk in itertools.product(
            _clip(_GM_SUPER, max(m, 256), align=8),
            _clip(_MM_LANE, n),
            _clip(_MM_LANE, k),
        ):
            vmem = 2 * (gm * bk + bk * bn) * dsize + gm * bn * (4 + dsize)
            steps = _cdiv(m, gm) * _cdiv(n, bn) * _cdiv(k, bk)
            hbm = (m * k * _cdiv(n, bn) + k * n * _cdiv(m, gm) + m * n) * dsize
            out.append(_mk({"gm": gm, "bn": bn, "bk": bk}, vmem, steps, hbm))
    elif schedule == "unicast":
        for bm, bn, bk in itertools.product(
            _clip(_MM_SUB, m, align=8), _clip(_MM_LANE, n), _clip(_MM_LANE, k)
        ):
            vmem = 2 * (bm * bk + bk * bn + bm * bn) * dsize + bm * bn * 4
            steps = _cdiv(m, bm) * _cdiv(n, bn) * _cdiv(k, bk)
            hbm = (m * k * _cdiv(n, bn) + k * n * _cdiv(m, bm) + m * n) * dsize
            out.append(_mk({"bm": bm, "bn": bn, "bk": bk}, vmem, steps, hbm))
    else:
        raise ValueError(f"unknown matmul schedule: {schedule!r}")
    return out


_FA_BLOCKS = (64, 128, 256, 512)


def _flash_candidates(shape: Sequence[int], dsize: int) -> list[Candidate]:
    """Shape key: (b, h, sq, sk, d).  The JAX kernel's (bq, bk) blocks
    must divide the sequences; a sequence no option divides is one block.
    These blocks model the TPU kernel's working set and grid steps (the
    schedule's cost); the CUDA kernels' tiles do not follow them."""
    b, h, sq, sk, d = shape
    out = []
    for bq, bk in itertools.product(_divisors(sq, _FA_BLOCKS), _divisors(sk, _FA_BLOCKS)):
        # q/k/v/o blocks double-buffered + fp32 softmax state scratch
        vmem = 2 * (bq * d + 2 * bk * d + bq * d) * dsize + bq * (2 + d) * 4
        steps = b * h * _cdiv(sq, bq) * _cdiv(sk, bk)
        out.append(_mk({"bq": bq, "bk": bk}, vmem, steps))
    return out


_SSD_CHUNKS = (32, 64, 128, 256)


def _ssd_candidates(shape: Sequence[int], dsize: int) -> list[Candidate]:
    """Shape key: (b, h, s, P, N).  The JAX kernel's chunk must divide the
    sequence (a sequence no option divides is one chunk) and its (P, N)
    state sits in VMEM; the CUDA kernels use a chunk of their own."""
    b, h, s, p, n = shape
    out = []
    for chunk in _divisors(s, _SSD_CHUNKS):
        # xdt/b/c/lcum/o blocks double-buffered + (P, N) state + (Q, Q) scores
        vmem = 2 * (2 * chunk * p + 2 * chunk * n + chunk) * 4 + (p * n + chunk * chunk) * 4
        steps = b * h * _cdiv(s, chunk)
        out.append(_mk({"chunk": chunk}, vmem, steps))
    return out


_PAGED_QC = (8, 16, 32, 64, 128)


def _paged_attention_candidates(schedule: str, shape: Sequence[int],
                                dsize: int) -> list[Candidate]:
    """Shape key: (b, s, h, kvh, pages_per_seq, page_size, d,
    n_scale_arrays).  ``"default"`` is the single-token decode kernel (one
    configuration), ``"prefill"`` the chunked-prefill supertile, whose
    q-chunk ``qc`` is the multicast fan-out of one K/V page fetch."""
    b, s, h, kvh, pages, ps, d, n_scales = shape
    group = max(1, h // max(kvh, 1))
    kv_size = 1 if n_scales else dsize  # int8 pages stream 1 byte/elt
    scale_vmem = 2 * 2 * ps * 2 if n_scales else 0  # bf16 scale columns
    if schedule == "prefill":
        out = []
        for qc in _clip(_PAGED_QC, s, align=1):
            rows = qc * group
            vmem = (
                2 * 2 * rows * d * dsize
                + 2 * 2 * ps * d * kv_size + scale_vmem
                + rows * (2 + d) * 4 + rows * ps * 4
            )
            q_chunks = _cdiv(s, qc)
            steps = b * kvh * q_chunks * pages
            hbm = (
                2 * b * s * h * d * dsize
                + 2 * kvh * pages * ps * d * kv_size * b * q_chunks
            )
            out.append(_mk({"qc": qc}, vmem, steps, hbm))
        return out
    vmem = 2 * (group * d * dsize + 2 * ps * d * kv_size) \
        + scale_vmem + group * (2 + d) * 4
    steps = b * kvh * pages
    hbm = b * h * d * dsize + 2 * kvh * b * pages * ps * d * kv_size
    return [_mk({}, vmem, steps, hbm)]


_LRU_BLOCKS = (128, 256, 512)


def _rglru_candidates(shape: Sequence[int], dsize: int) -> list[Candidate]:
    """Shape key: (b, s, d); the JAX kernel's (bs, bd) blocks divide the
    sequence and the channels, else span them whole."""
    b, s, d = shape
    out = []
    for bs, bd in itertools.product(_divisors(s, _LRU_BLOCKS), _divisors(d, _LRU_BLOCKS)):
        vmem = 2 * 3 * bs * bd * 4 + bd * 4  # a/b/h blocks double-buffered + the carry
        steps = b * _cdiv(d, bd) * _cdiv(s, bs)
        out.append(_mk({"bd": bd, "bs": bs}, vmem, steps))
    return out


_GENERATORS = {
    "matmul": _matmul_candidates,
    "paged_attention": _paged_attention_candidates,
    "flash_attention": lambda schedule, shape, dsize: _flash_candidates(shape, dsize),
    "ssd": lambda schedule, shape, dsize: _ssd_candidates(shape, dsize),
    "rglru": lambda schedule, shape, dsize: _rglru_candidates(shape, dsize),
}


def candidates(kernel: str, shape: Sequence[int], dtype: torch.dtype | str, *,
               schedule: str = "default") -> list[Candidate]:
    """``VMEM_BUDGET``-pruned candidate configs, best cost-model score first."""
    return list(_candidates_cached(kernel, tuple(int(s) for s in shape), dtype_name(dtype),
                                   schedule))


@functools.lru_cache(maxsize=4096)
def _candidates_cached(kernel: str, shape: tuple[int, ...], dtype: str,
                       schedule: str) -> tuple[Candidate, ...]:
    if kernel not in _GENERATORS:
        raise ValueError(f"unknown kernel family: {kernel!r} (have {sorted(_GENERATORS)})")
    cands = _GENERATORS[kernel](schedule, shape, _ITEMSIZE[dtype])
    pruned = [c for c in cands if c.vmem_bytes <= VMEM_BUDGET]
    if not pruned:  # degenerate giant shape: keep the smallest footprint
        pruned = [min(cands, key=lambda c: c.vmem_bytes)]
    return tuple(sorted(pruned, key=lambda c: c.cost))
