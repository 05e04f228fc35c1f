"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card.  Phases,
each fatal on failure (nothing is caught):

1. build the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) and print the card's name and power limit;
2. hold every kernel against its plain PyTorch version on the card at
   the serving paths' shapes, timing kernel, plain version and a PyTorch
   library call with CUDA events (median of 25 runs, L2 flushed before
   each), beside the least time the card could take (``bound_ms``); for
   each matmul shape also the three schedules side by side — K1 tiled
   (grouped raster: B reused through L2), K4 mcast (thread-block
   clusters: B fetched once per cluster by TMA multicast), K5 unicast
   (B once per row block) on the same inputs — with the B bytes the
   schedules' traffic model gives each and how often each fetches B (the
   paper's comparison); every K1, K4 and K5 record names the design its
   kernel's rule picked and fails unless it is the tensor-core one
   (``wgmma-swapab`` up to 64 rows, ``wgmma-swapab-3xbf16`` for the fp32
   logits, above 64 rows ``wgmma``, for K4 ``wgmma-cluster`` with its
   cluster size); K2 and K3 at the rows of ``DECODE_ROWS`` and
   ``PREFILL_ROWS`` (the serving shapes, GQA, fp32 pools, contexts up to
   4K, the last 512-token chunk of a 2,048-token prompt, int8 pools, a
   first chunk), each record naming its design — ``split-kv`` (K2) and
   ``wgmma`` (K3) for bf16 and int8 pools, ``cuda-core`` for fp32 ones,
   else the check fails — its split count, and its time after a flush
   that leaves L2 clean beside the usual one; and the speculative
   slice's operating points: K1 at qwen1.5-1.8b's projections at its
   decode (4 rows) and verify (20 rows) shapes and its untied fp32 logits
   (``PAIR_MATMUL_ROWS``: the bf16 (d, vocab) head read row-major), K2
   at head dim 128, K3 at head dim 128 on int8 pools at s = 5, s = 1 and
   the 28-token suffix of a prefix hit, and on bf16 pools at s = 5 and 28
   (the rows at command-r-35b's and pixtral-12b's heads draw from a
   generator of their own, ``FAMILY_PAGED``);
2b. gradients: K6, K7 and K8 (flash attention forward, dQ, dK/dV) each
   against its plain version at six shapes — qwen1.5-0.5b and gemma2-9b's
   local layers at full width, the kernel benchmark's flash row, two
   ragged cross-attention cases, one with rows that see no key, and one
   head of 128 whose row 0 sees one key — timed as in phase 2, each
   record naming the design that ran (``wgmma`` for bf16 with d % 8 == 0,
   else ``cuda-core``; rows that see one key are held to the rounding
   bound of ``single_key_rounding``); then the differentiated path,
   ``torch.autograd.grad``
   through ``op("flash_attention")`` at the two full-width shapes, every
   launch count at 0 before it, against the same graph on the plain
   versions (one forward must launch K6 once, one backward K7 and K8
   once each), its dK and dV also against an fp64 autograd reference
   (the kernel within the allowance of it, or no farther than the plain
   version is); then ``grad(linear)`` at qwen's gate projection over
   2 x 2048 tokens under ``tiled``, ``mcast`` and ``unicast`` (one
   forward matmul launch, then z, dA and dB, each on K1's ``wgmma``);
2c. scans: K9 and K10 (the SSD chunked scan with its checkpoints, and its
   reverse-chunk adjoint) at four shapes — mamba2-780m's SSD layer at full
   width, the kernel benchmark's row, a ragged sequence and a 256 KB
   state — each record naming the design that ran, which must be
   ``chunk-parallel`` (three CUDA launches a call: the chunks'
   contributions with the head-shared scores, the pass over the chunks,
   the outputs or gradients; products in 3xTF32; the launches counted in
   a profiler trace), and its bound taken at the card's rate for
   fp32-accurate products (TF32 / 3), the kernels and the plain versions
   each also held to the scan in fp64 at the same tolerance; and K11 and K12
   (the RG-LRU recurrence and its adjoint) at four — recurrentgemma-2b's
   at full width, the same width at the train_4k sequence length with slow
   decays, the benchmark's row and a ragged one — each record naming the
   design that ran, which must be ``chunked-lookback`` (one CUDA launch a
   call, counted in profiler traces), each against its plain version and
   both held to the recurrence in fp64, and timed as in phase 2;
   then ``torch.autograd.grad`` through ``op("ssd")`` and ``op("rglru")``
   at the full-width shapes, every launch count at 0 before each (one
   forward must launch K9 / K11 once, one backward K10 / K12 once),
   against PyTorch's autograd through the plain forward;
3. build qwen1.5-0.5b at full width from a seed and compare one prefill
   and one decode step run through the kernels with the same run through
   the plain versions: paged decode under the default policy, and dense
   decode under each of ``tiled``, ``mcast`` and ``unicast``, each decode
   step also timed, counted and profiled (device ops and their summed
   ms), and the host cost of one schedule resolution; then qwen1.5-1.8b
   at full width (untied head, head dim 128) on int8 pools: a cold
   prefill quantised into pages, a plain decode step and a verify step
   at s = 5 for a batch of 4, through the kernels and through the plain
   versions (``TOL_MODEL``), each step timed, counted and profiled;
4. serve 8 requests (32-token shared prefix, 40-60-token prompts, 32 new
   tokens each) through ``PagedEngine`` under the default policy, and
   through the dense ``Server`` under the default policy, ``mcast`` and
   ``unicast``; then qwen1.5-1.8b at full width over the same requests
   on int8 pools — plain, speculative (k = 4) with its registered draft
   qwen1.5-0.5b (``draft_for``), speculative with the n-gram draft — and
   on bf16 pools, plain and speculative with the draft (so that K2 serves
   the 1.8b).  Each run starts with every launch count at 0 and fails
   unless every request drained, the paged engine's ``check()`` passed
   and every kernel of its path — and no other — was launched (the
   matmul kernels as dispatch picks them at the path's shapes).  The
   speculative records carry the accept rate, rounds and rollback
   pages, how many streams equal the plain run's on the same pools, and
   for each that differs the plain run's top-two logit margin at the
   first differing token, which must be within ``TOL_MODEL`` of that
   row's largest |logit| (a near-tie: verify at s = 5 and decode at
   s = 1 split K3 differently); each plain run's ``near_tie_share``
   record says what share of its tokens falls under that bound.
   Phases 2-4 inject no fault: they must end with no kernel fallback and
   no reference schedule run (``check_clean``; every family's reference
   schedule is counted, ``count_reference_calls``);
5. the reference backend, degraded serving and the async loop, on
   qwen1.5-0.5b at full width: (a) one prefill and one decode step under
   ``use_policy("reference")`` against the kernel path (``TOL_MODEL``),
   the reference step timed beside the kernel step (what one fallback
   retry costs) and launching no kernel; (b) the paged engine over a pool
   that preempts (``DEGRADED_PAGES``) — guards off, then ``kv_guard`` and
   ``kernel_fallback`` armed with no plan (streams identical, nothing
   falls back), then under ``degraded_plan`` (kernel raises and a NaN
   output, a corrupted cached page, a lost swap blob, a forced pool
   exhaustion): every request drains (the plan requeues none past
   ``MAX_DEGRADE_REQUEUES``, so none may fail), the audit holds,
   the fallbacks counted equal the kernel faults fired, pages were
   quarantined, streams equal the clean run's but at near-ties; (c)
   ``ServeLoop`` over a seeded Poisson trace (1.5 requests/s for 6 s,
   half with a 32-token shared prefix, 24-32 new tokens) after
   ``warmup_for_trace``: tokens/s, TTFT and ITL percentiles, occupancy,
   prefills mid-decode, no kernel library loaded during the trace, the
   snapshot schema-valid, streams equal the sync replay's but at
   near-ties;
6. mixture-of-experts serving, moonshot-v1-16b-a3b (64 experts top-6 of
   d_ff 1408, 2 shared experts, d 2048, vocab 163,840) at full width and
   full depth (48 layers: no cut), built on the card from a seed once
   every earlier model is freed: K1, K4 and K5 in their grouped form —
   one launch over all 64 experts — at the experts' decode shapes (64 x
   (24 x 2048 -> 1408), silu and bare, and 64 x (24 x 1408 -> 2048)) and
   a 512-token prompt's gate (64 x (60 x 2048 -> 1408)), each against
   its plain version (``TOL_BF16``), timed beside ``torch.bmm`` on the
   same operands and the stack's bound, naming its design
   (``wgmma-swapab``) and K split; then one 45-token prefill and one
   decode step for a batch of 4 under the default policy, ``mcast`` and
   ``unicast``, every layer's attention, MLP or MoE and the logits held
   to the plain versions on the kernel run's own inputs (``LayerCheck``,
   ``TOL_MODEL``; at full depth the random-weight stack turns a last-bit
   difference into unrelated logits, so a whole plain run is only
   reported, ``model_unpinned``), each decode step timed, profiled (its
   top device ops by name) and its launches counted by kernel, beside the
   bound of reading every weight once (the reference dispatch computes
   every expert at every step); then the dense ``Server`` over 4 prompts
   of 16-64 tokens (8-16 new tokens) under each policy at full depth
   (every request drained, its policy's matmul kernel and no other
   launched, tokens/s and TTFT), and on the first ``MOE_STREAM_DEPTH`` =
   4 layers through the kernels and through the plain versions with the
   kernel run's experts replayed: every kernel stream equal to its plain
   run's but at near-ties.  Depth is cut only there;
7. recurrent serving, mamba2-780m (48 SSD layers) and recurrentgemma-2b
   (RG-LRU and window-2048 local attention, 26 layers) at full width and
   full depth, built on the card from a seed once moonshot is freed: K1,
   K4 and K5 through ``kernels.linear`` at every new projection
   (``RECURRENT_ROWS``: mamba2's in / out projections and tied logits,
   recurrentgemma's gelu and bare branches, the RG-LRU gate with bias,
   sigmoid and fp32 output, the MQA k / v, the gelu_tanh GLU and down
   projections, its tied logits) at M 4 and 45 under each policy, each
   held to the same call on the plain versions, timed beside
   ``torch.matmul`` / ``torch.addmm`` and its bound, naming its design;
   then per model one 45-token prefill and one batch-4 decode step per
   policy with every layer (RG-LRU and SSD blocks and their steps,
   local-window attention, MLP) and the logits held to the plain
   versions (``LayerCheck``), the whole run reported against a whole
   plain run (``model_whole``), the decode step timed, profiled and
   counted beside the weights' bound; a 4,096-token prefill (batch 1,
   only the last row's logits) and 4 decode steps, every layer held,
   recurrentgemma's local layers on the banded path with 2,048-slot
   rings holding the last positions, mamba2 over 32 chunks; and the
   dense ``Server`` over the phase-6 prompts per policy at full depth
   (every request drained, only its policy's matmul kernel launched,
   streams equal to a plain run's but at near-ties);
8. the last model families at full width and full depth, one model at a
   time, each built on the card from a seed and freed before the next:
   K1, K4 and K5 through ``kernels.linear`` at their new projections
   (``FAMILY_ROWS`` at M 4 and 45; ``FAMILY_WIDE_ROWS``: whisper's
   encoder input over two 1,500-frame clips, bf16 out, and pixtral's
   front end over 512 patches), as in phase 7 (K2 and K3 at command-r's
   group 8 and pixtral's group 4, d 128, are rows of phase 2); then
   whisper-medium through ``models/encdec.py`` (1,500 seeded frames of
   1,024 for a batch of 2, a 16-token prompt, 16 greedy decode steps:
   counted, timed, every layer held — bidirectional encoder layers, self,
   cross and cached cross attention, MLPs, logits — and the encoder
   output and every step's logits against a plain run fed the same
   tokens); pixtral-12b (256 patch embeddings through ``frontend_proj``
   and a 32-token prompt, batch 2, then 8 decode steps on the dense
   caches, likewise); gemma2-9b (post-block norms, softcaps, window-4096
   layers) as phase 7 runs its models, prefill and decode step per
   policy under ``LayerCheck`` and the dense ``Server`` per policy
   against a plain run; deepseek-7b's prefill and decode step under the
   default policy; command-r-35b (60.6 GB of bf16, no depth cut) on the
   paged path — a prefill and decode step, and a 28-token suffix prefill
   over a 32-token prefix's pages (K3 at group 8) — under ``LayerCheck``
   and then the paged engine over the phase-4 requests (prefix hits: K3
   suffix prefills and K2 decode steps at group 8, their designs
   asserted).  Where a whole run leaves
   ``TOL_MODEL`` the depth-gap witness runs (``check_depth_gap``;
   whisper's: the plain run on frames with their last bit flipped).  It
   prints the phase's seconds.
9. training (``check_training``, after every earlier model is freed):
   ``grad(grouped_linear)`` with silu at moonshot-v1-16b-a3b's expert
   shapes (64 x (24 | 60 x 2048 -> 1408)) under each policy — one grouped
   launch forward, z, dA and dB one grouped K1 launch each, each held to
   its plain version on its own inputs and timed beside its bound and
   ``torch.matmul``, dx and dw to the plain graph with the dz-rounding
   allowance of ``check_linear_grad``; the tied head's three fp32
   products at the training shape (1,024 tokens x 1,024 -> 151,936:
   forward, dA, dB), their design, time, bound and ``torch.matmul``; a
   train step of qwen1.5-0.5b at full width and depth (batch 8, seq 128,
   ``build_train_step``'s loss) per policy, every gradient leaf held to
   the same step on the plain versions (``GRAD_REL`` or the spread of two
   flipped-ulp witnesses, ``spread``); the step split into forward, backward and optimizer (host
   and device ms), profiled, its launches and peak memory; the launcher
   (``launch.train.main``) for 8 steps with a checkpoint every 4, crashed
   at step 6 and resumed from step 4; a train step of
   moonshot-v1-16b-a3b at full width, its depth cut to 2 layers (full
   depth needs about 190 GB), held as qwen's; and the down projection's
   weight gradient (hᵀ dz, 2,816 x 1,024 x 1,024, hᵀ M-major) on K4 as
   the default policy sends it, its design, time, bound and
   ``torch.matmul`` on the same strided operands.  It prints the phase's
   seconds.
10. the trace tooling (``check_trace_tooling``): the port's launchers at
   full width, each run untraced and then with ``--trace`` into a
   temporary directory — (a) qwen1.5-0.5b on the paged engine with a
   32-token shared prefix, (b) qwen1.5-1.8b speculating (k = 4) with its
   registered draft, (c) the ``--server`` loop over a seeded Poisson
   trace, (d) ``launch.train`` for 2 steps.  Weights and requests come from
   the launchers' seeds (nothing from the shared generator); each runs
   untraced and traced twice over, alternating.  Each fails unless every
   run's streams (losses) are equal, the
   trace and its ``obs.analyze`` report validate with nothing dropped, the
   report's kernel calls, pool and prefix keys equal the engine's live
   counters (the speculation keys its ``stats()``; the loop's TTFT p50 from
   the spans its metrics' within the trace's microsecond), and the run
   launched the kernels its untraced twin did.  Each record carries event
   counts, dispatch spans by ``<op>_<schedule>`` and by design, the
   B-fetch share the tiles avoid, the step's wall ms with and without
   tracing, and where each ``engine.*`` span closes against the device work
   it enqueued (CUDA events at the span's ends).  Before them,
   ``check_tracing_cost`` reads what tracing costs the host inside one
   process: µs per unarmed check, per dispatch record and per traced
   ``kernels.linear`` call, and the paged launcher with a recorder armed
   on every other engine step (each armed step against its neighbours).
   It prints the phase's seconds.

After the build it prints ptxas's registers, stack and spills for every
kernel instantiation.  It prints one JSON line per check, then the card
line, the kernel summary (launches: the serving runs of phases 4 to 8,
the training runs of phase 9 and the traced runs of phase 10 for K1–K5, phase 2b's autograd paths
for K6–K8, phase 2c's for K9–K12; K1, K4 and K5 also carry their grouped form's numbers, phase
6's first row, under ``grouped``) and, last,
``{"ok": true, "device": {...}}``.
Without a CUDA device, or run outside a checkout of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple
from unittest import mock

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch/csrc not found)")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import api  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.flash_attention import _mask  # noqa: E402
from repro_torch.kernels.matmul import (  # noqa: E402
    hbm_traffic_model,
    kernel_blocks,
    matmul_mcast,
    matmul_mcast_plain,
    matmul_tiled,
    matmul_tiled_plain,
    matmul_unicast,
    matmul_unicast_plain,
)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    gather_pages,
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_prefill,
    paged_attention_prefill_plain,
)
from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: E402
    _DTYPE_CODES,
    _decode_splits,
    _prefill_splits,
    prefill_chunk,
)
from repro_torch.kernels.rglru import (  # noqa: E402
    rglru_scan,
    rglru_scan_bwd,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
    rglru_scan_ref,
)
from repro_torch.kernels.ssd import (  # noqa: E402
    SSD_CHUNK,
    ssd_lcum,
    ssd_scan,
    ssd_scan_bwd,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
)
from repro_torch.configs.shapes import ShapeCfg  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import batch as data_batch  # noqa: E402
from repro_torch.dist.step import build_train_step, value_and_grad  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten_with_paths, map_structure  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.nn import attention as attn_mod  # noqa: E402
from repro_torch.nn import memeff as memeff_mod  # noqa: E402
from repro_torch.nn import moe as moe_mod  # noqa: E402
from repro_torch.nn import rglru as rglru_mod  # noqa: E402
from repro_torch.nn import ssd as ssd_mod  # noqa: E402
from repro_torch.configs.registry import draft_for  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Fault,
    FaultPlan,
    GreedySampler,
    Lifecycle,
    LoadGen,
    PagedEngine,
    Request,
    ServeConfig,
    ServeLoop,
    validate_snapshot,
)

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.  They assume the 700 W limit; the card line says the
# limit this run had.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12  # outside the tensor cores
PEAK_TF32 = 495e12
# fp32-accurate products on the tensor cores (K9/K10's 3xTF32, the matmuls'
# fp32 x bf16 wgmma-swapab-3xbf16): three passes, taken at PEAK_TF32 / 3
PEAK_FP32_ACCURATE = PEAK_TF32 / 3
HBM_BYTES_PER_S = 3.35e12

# Stated tolerances (compared in fp32).  bf16 outputs: 2e-2 absolute and
# relative, about two bf16 ulps — kernel and plain version sum in other
# orders, so a rounding can land on the other side of a tie.  fp32
# outputs of K1 (the logits): 1e-4, the reordered fp32 sum over K=1024.
TOL_BF16 = 2e-2
TOL_FP32 = 1e-4
# K6-K8 outputs (attention averages and their gradients) are small where
# a row averages thousands of keys (|o| ~ 0.03 at gemma2's window), so a
# fixed 2e-2 floor would pass almost anything there.  Their absolute term
# is the tolerance times the RMS of the element's row (its last axis)
# instead: |got - want| <= tol * (|want| + rms(want's row)).  The rounding
# gap it must admit is K6's: the kernel rounds p to bf16 against the
# running row max, the plain version against the final one, two
# independent roundings of up to 2^-9 relative per kept key, whose sum
# over a row stays within a few 2^-9 of the row's RMS.
# K9-K12 outputs (fp32 scans) are held the same way at TOL_SCAN: kernel
# and plain version sum the same fp32 terms in other orders; the row is
# the last axis (P, N or d), and the sequence for d log a.
TOL_SCAN = 1e-4
# whole-model logits: fp32, but built on 24 layers of bf16 activations in
# which such ties recur; held to 2e-2 of the largest logit.
TOL_MODEL = 2e-2

KERNEL_META = {
    "matmul_tiled": ("src/repro_torch/csrc/matmul_tiled.cu",
                     "src/repro/kernels/matmul/matmul.py:153"),
    "matmul_mcast": ("src/repro_torch/csrc/matmul_mcast.cu",
                     "src/repro/kernels/matmul/matmul.py:77"),
    "matmul_unicast": ("src/repro_torch/csrc/matmul_unicast.cu",
                       "src/repro/kernels/matmul/matmul.py:232"),
    "paged_attention_decode": ("src/repro_torch/csrc/paged_attention_decode.cu",
                               "src/repro/kernels/paged_attention/paged_attention.py:105"),
    "paged_attention_prefill": ("src/repro_torch/csrc/paged_attention_prefill.cu",
                                "src/repro/kernels/paged_attention/paged_attention.py:240"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_fwd.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:96"),
    "flash_attention_bwd_dq": ("src/repro_torch/csrc/flash_attention_bwd_dq.cu",
                               "src/repro/kernels/flash_attention/flash_attention.py:248"),
    "flash_attention_bwd_dkv": ("src/repro_torch/csrc/flash_attention_bwd_dkv.cu",
                                "src/repro/kernels/flash_attention/flash_attention.py:281"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan_fwd.cu", "src/repro/kernels/ssd/ssd.py:76"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu", "src/repro/kernels/ssd/ssd.py:218"),
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan_fwd.cu",
                   "src/repro/kernels/rglru/rglru.py:49"),
    "rglru_scan_bwd": ("src/repro_torch/csrc/rglru_scan_bwd.cu",
                       "src/repro/kernels/rglru/rglru.py:98"),
}
POLICIES = ("tiled", "mcast", "unicast")
# (m, k, n, logits) of check_schedules: qwen1.5-0.5b's decode projections
# (q/k/v/o, gate/up, down), a 48-token prefill, the tied logits (fp32
# activations x the bf16 table read transposed), and M 256 and 2049
SCHEDULE_SHAPES = ((4, 1024, 1024, False), (4, 1024, 2816, False), (4, 2816, 1024, False),
                   (48, 1024, 2816, False), (4, 1024, 151936, True), (256, 1024, 2816, False),
                   (2049, 1024, 2816, False))
MATMULS = ("matmul_tiled", "matmul_mcast", "matmul_unicast")
# K1 rows of the speculative slice, (label, m, k, n, check_matmul keywords):
# qwen1.5-1.8b's projections (q/k/v/o with bias, gate with silu, down) at
# its decode (4 rows) and verify (4 x (k + 1) = 20 rows) shapes, and its
# untied fp32 logits against the bf16 (d, vocab) head read row-major
PAIR_MATMUL_ROWS = tuple(
    (f"1.8b-{step}-{proj}", m, k, n, kw)
    for step, m in (("decode", 4), ("verify", 20))
    for proj, k, n, kw in (("qkvo", 2048, 2048, {}),
                           ("gate", 2048, 5504, dict(bias=False, activation="silu")),
                           ("down", 5504, 2048, dict(bias=False)),
                           ("logits", 2048, 151936, dict(logits="untied")))
)
# K2 and K3 rows of phase 2, (label, check_decode / check_prefill keywords);
# the first of each is the kernels line's.  qwen1.5-0.5b's attention (h 16,
# kv heads 16, d 64, page 16) at the serving shapes, GQA, fp32 pools (the
# cuda-core designs), contexts up to 4K (b 8, 256 pages a sequence) and the
# last 512-token chunk of a 2,048-token prompt; K3 also int8 pools and a
# first chunk (start 0, where a query sees few keys)
DECODE_ROWS = (
    ("serving", {}),
    ("gqa", dict(kvh=4)),
    ("fp32", dict(dtype=torch.float32)),
    ("long", dict(b=8, n=256, lengths=(4096, 3584, 2048, 1024, 4096, 777, 3000, 1), runs=10)),
    # qwen1.5-1.8b's attention (16 heads of 128, page 16), contexts 40-300
    ("d128", dict(d=128, n=19, lengths=(40, 300, 129, 77))),
    # command-r-35b's (64 heads over 8 KV heads of 128: group 8) and
    # pixtral-12b's (32 over 8: group 4)
    ("cr-g8-d128", dict(h=64, kvh=8, d=128, n=19, lengths=(40, 300, 129, 77))),
    ("px-g4-d128", dict(h=32, kvh=8, d=128, n=19, lengths=(40, 300, 129, 77))),
)
PREFILL_ROWS = (
    ("serving", {}),
    ("gqa-ragged", dict(s=5, lengths=(37,), kvh=4)),
    ("int8", dict(quant=True)),
    ("fp32", dict(dtype=torch.float32)),
    ("long", dict(s=512, n=128, lengths=(2048,), runs=10)),
    ("first-chunk", dict(lengths=(16,))),
    # qwen1.5-1.8b on int8 pools: a verify burst (s = k + 1 = 5) and a
    # decode token (int8 decode runs K3) per sequence, contexts 40-300
    ("int8-d128-verify", dict(b=4, s=5, d=128, n=19, lengths=(40, 300, 129, 77), quant=True)),
    ("int8-d128-decode", dict(b=4, s=1, d=128, n=19, lengths=(40, 300, 129, 77), quant=True)),
    # its prefix-hit suffix prefill (the longest serving suffix: 28 tokens
    # after the 32-token shared prefix) on int8 and bf16 pools, and the
    # bf16 pools' verify burst
    ("int8-d128-suffix", dict(s=28, d=128, lengths=(60,), quant=True)),
    ("d128-suffix", dict(s=28, d=128, lengths=(60,))),
    ("d128-verify", dict(b=4, s=5, d=128, n=19, lengths=(40, 300, 129, 77))),
    # command-r-35b's suffix prefill (64 heads over 8 KV heads: group 8, 28
    # tokens x 8 = 224 rows a KV head) and pixtral-12b's (32 over 8)
    ("cr-g8-d128-suffix", dict(s=28, h=64, kvh=8, d=128, lengths=(60,))),
    ("px-g4-d128-suffix", dict(s=28, h=32, kvh=8, d=128, lengths=(60,))),
)
# the rows above at command-r-35b's and pixtral-12b's heads: they draw from
# a generator of their own, so the draws of every check after them do not
# depend on them
FAMILY_PAGED = ("cr-g8-d128", "px-g4-d128", "cr-g8-d128-suffix", "px-g4-d128-suffix")


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def ptxas_entries(log: str) -> list[tuple[str, str]]:
    """(kernel entry, "N bytes stack frame, N bytes spill stores, N bytes
    spill loads; Used N registers ...") for each entry of an nvcc -Xptxas
    -v log, its name demangled where c++filt is found."""
    out, entry, frame = [], None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry, frame = line.split("'")[1], ""
        elif "bytes stack frame" in line:
            frame = line.split(":", 1)[-1].strip() if ":" in line else line
        elif "Used" in line and entry is not None:
            out.append((entry, f"{frame}; {line.split(':', 1)[-1].strip()}"))
            entry = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(e for e, _ in out),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [e for e, _ in out]
    if len(names) != len(out):
        names = [e for e, _ in out]
    return [(name, props) for name, (_, props) in zip(names, out)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None
SPIN_HZ = 2.0e9  # cycles per second for torch.cuda._sleep (above the H100's clock)


def time_ms(fn, runs: int = 25, warmup: int = 3, max_spin_s: float = 0.05,
            clean_l2: bool = False) -> tuple[float, float]:
    """(median device ms, host ms) of one ``fn()``: device time by CUDA
    events over ``runs``, host time as the wall time to enqueue it.

    Before each run the 50 MB L2 cache is flushed, as the serving path
    finds its weights (a decode step streams far more than L2 holds), and
    the card is kept busy with a spin kernel longer than the host takes
    to enqueue ``fn``, so the events bracket device work only and not the
    Python and launch overhead between them.  The flush writes 64 MB, so
    ``fn`` finds L2 full of dirty lines and its misses also pay their
    write-back; ``clean_l2`` flushes by reading the 64 MB instead (L2 then
    holds clean lines only)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(min(max(4 * host_s, 2e-4), max_spin_s) * SPIN_HZ)
    times = []
    for _ in range(runs):
        if clean_l2:
            _FLUSH.max()
        else:
            _FLUSH.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), host_s * 1e3


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def check_close(name: str, got, want, tol: float, extra=None) -> float:
    """|got - want| <= tol + tol * |want| elementwise (rtol = atol = tol),
    plus ``extra`` (per element) where given: the computed effect of an
    intermediate rounding that two correct runs may take either way
    (:func:`check_linear_grad`)."""
    torch.cuda.synchronize()
    g, w = got.detach().float(), want.detach().float()
    allow = tol + tol * w.abs() + (0.0 if extra is None else extra.float())
    ok = bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= allow).all())
    err = max_err(got, want)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree beyond rtol=atol="
                             f"{tol} (max abs err {err})")
    return err


def tc_sum_allowance(want: torch.Tensor, k: int) -> torch.Tensor:
    """What the tensor cores' fp32 accumulation may move an fp32-A matmul
    (``wgmma-swapab-3xbf16``) from its fp64 plain version at depth ``k``:
    the accumulator drops the bits below its last place on each of the
    3 * ceil(k / 16) accumulation steps of the three bf16 passes, up to
    one ulp (2^-23 relative) of the running sum each time, taken here as
    |want| + the RMS of want's row.  Measured on an H100: 3.1e-4 at k
    3584 and |C| ~ 20, beyond TOL_FP32, which was set at k 1024."""
    w = want.detach().float()
    steps = 3 * -(-k // 16)
    return steps * 2.0 ** -23 * (w.abs() + w.square().mean(dim=-1, keepdim=True).sqrt())


def flash_atol(want: torch.Tensor, tol: float) -> torch.Tensor:
    """The flash checks' absolute term: ``tol`` times the RMS of each
    element's row (the last axis: a query's output or dQ, a key's dK/dV)."""
    return tol * want.detach().float().square().mean(dim=-1, keepdim=True).sqrt()


def flash_ratios(got, want, tol: float, rounding=None, atol=flash_atol) -> torch.Tensor:
    """Each element's |got - want| over its allowance, atol(want, tol) +
    tol * |want| (<= 1 passes).

    ``rounding``: (rows, bound) from :func:`single_key_rounding`, rows of
    the second-to-last axis whose exact value is 0 and that each side
    returns as its own rounding.  Those rows are held instead to
    |got| <= bound and |want| <= bound: their ratio is the larger of the
    two over the bound."""
    g, w = got.detach().float(), want.detach().float()
    diff, allow = (g - w).abs(), atol(w, tol) + tol * w.abs()
    ratios = torch.where(diff > 0, diff / allow, torch.zeros_like(diff))
    if rounding is not None:
        rows, bnd = rounding
        worst = torch.maximum(g[..., rows, :].abs(), w[..., rows, :].abs())
        ratios[..., rows, :] = torch.where(worst > 0, worst / bnd, torch.zeros_like(worst))
    return ratios


def check_flash_close(name: str, got, want, tol: float, rounding=None) -> tuple[float, float]:
    """|got - want| <= flash_atol(want) + tol * |want| elementwise, with
    ``rounding``'s rows held to their bound (:func:`flash_ratios`); returns
    (max abs err, the largest ratio — <= 1 passes — and the least fixed
    absolute term that would pass at rtol = tol)."""
    torch.cuda.synchronize()
    g, w = got.detach().float(), want.detach().float()
    diff = (g - w).abs()
    ratio = float(flash_ratios(g, w, tol, rounding).max())
    ok = bool(torch.isfinite(g).all()) and ratio <= 1
    err, fixed = float(diff.max()), float((diff - tol * w.abs()).clamp(min=0).max())
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree beyond "
                             f"tol={tol} x (|want| + row rms) (max abs err {err}, "
                             f"worst err / allowance {ratio:.3g})")
    return err, ratio, fixed


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def matmul_operands(gen, m, k, n, *, logits=False, bias=False):
    """A, B and the bias of a matmul check.  ``logits``: True for the tied
    head (fp32 activations x the bf16 (vocab, d) table read transposed),
    ``"untied"`` for an untied head (x the bf16 (d, vocab) ``unembed.w``
    read row-major, qwen1.5-1.8b's), neither with a bias; else bf16
    activations x a bf16 B scaled by 1/sqrt(k), with a bf16 bias if
    ``bias``."""
    dev = "cuda"
    if logits:
        a = torch.randn(m, k, device=dev, generator=gen) * 4
        if logits == "untied":
            b = (torch.randn(k, n, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
        else:
            b = (torch.randn(n, k, device=dev, generator=gen) * 0.02).to(torch.bfloat16).t()
        return a, b, None
    a = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    b = (torch.randn(k, n, device=dev, generator=gen) / math.sqrt(k)).to(torch.bfloat16)
    bb = torch.randn(n, device=dev, generator=gen).to(torch.bfloat16) if bias else None
    return a, b, bb


def matmul_bound(a, b, bias, out_dtype) -> tuple[float, str]:
    """The least time of ``a @ b`` (+ ``bias``) into ``out_dtype`` (2-D, or
    (g, m, k) x (g, k, n) for g products): each operand read once and the
    output written once; 2 g m n k flops at PEAK_BF16 for bf16 x bf16, else
    at PEAK_FP32_ACCURATE (an fp32 operand runs on the tensor cores,
    fp32-accurate: wgmma-swapab-3xbf16)."""
    (m, k), n = a.shape[-2:], b.shape[-1]
    g = a.numel() // (m * k)
    nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() \
        + g * m * n * torch.empty((), dtype=out_dtype).element_size() \
        + (0 if bias is None else bias.numel() * bias.element_size())
    both_bf16 = a.dtype == b.dtype == torch.bfloat16
    return bound(2.0 * g * m * n * k, nbytes, PEAK_BF16 if both_bf16 else PEAK_FP32_ACCURATE)


def matmul_library(a, b, bias=None, activation="none") -> tuple[str | None, float | None]:
    """The library call timed beside a matmul kernel on its operands (2-D,
    or one batch of groups): none for fp32 x bf16 (no single call
    multiplies them), ``torch.addmm`` for a bias alone, else
    ``torch.matmul`` (without the epilogue, if any)."""
    if a.dtype != b.dtype:
        return None, None
    if bias is not None and activation == "none":
        return "torch.addmm", time_ms(lambda: torch.addmm(bias, a, b))[0]
    name = "torch.matmul" if bias is None and activation == "none" \
        else "torch.matmul (no epilogue)"
    return name, time_ms(lambda: torch.matmul(a, b))[0]


def check_matmul(gen, m, k, n, *, bias=True, activation="none", logits=False, label=""):
    """K1 against its plain version at one shape (:func:`matmul_operands`)."""
    a, b, bb = matmul_operands(gen, m, k, n, logits=logits, bias=bias)
    before = matmul_tiled.launches
    got = matmul_tiled(a, b, bb, activation=activation)
    assert matmul_tiled.launches == before + 1
    design = expect_design("matmul_tiled", m, k, n, logits)
    want = matmul_tiled_plain(a, b, bb, activation=activation)
    tol = TOL_FP32 if got.dtype == torch.float32 else TOL_BF16
    err = check_close(f"matmul_tiled {m}x{k}x{n}", got, want, tol)
    b_ms, b_by = matmul_bound(a, b, bb, got.dtype)
    library, lib_ms = matmul_library(a, b, bb, activation)
    k_ms, k_host = time_ms(lambda: matmul_tiled(a, b, bb, activation=activation))
    rec = dict(check="kernel", name="matmul_tiled", row=label, shape=[m, k, n],
               a_dtype=str(a.dtype), b_dtype=str(b.dtype), out_dtype=str(got.dtype),
               b_layout="k-major (table.t())" if logits is True else "n-major",
               bias=bb is not None, activation=activation, design=design, kernel_ms=k_ms,
               host_ms=k_host,
               plain_ms=time_ms(lambda: matmul_tiled_plain(a, b, bb, activation=activation))[0],
               library=library, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_err=err, tol=tol)
    emit(rec)
    return rec


def expect_design(kernel: str, m: int, k: int, n: int, logits: bool) -> str:
    """The design ``kernel`` just launched, checked against the
    tensor-core one its rule gives these shapes (every matmul check here
    has a bf16 B that TMA reads): fails otherwise."""
    want = ("wgmma-swapab-3xbf16" if logits else "wgmma-swapab" if m <= 64
            else "wgmma-cluster" if kernel == "matmul_mcast" else "wgmma")
    got = kernels.KERNELS[kernel].design
    if got != want:
        raise AssertionError(f"{kernel} {m}x{k}x{n}: design {got}, expected {want}")
    return got


def check_schedules(gen, m, k, n, *, logits=False):
    """K1, K4 and K5 on the same inputs computing the same function,
    ``C = A @ B`` in a's dtype with no epilogue: each against the plain
    version, each timed, with the traffic model's B bytes for each
    schedule at the kernels' own tile sizes and how often each fetches B
    from global memory (K4: once per cluster of CL row blocks, CL from its
    C rule).  Emits one kernel record for K4 and one for K5, then the
    side-by-side record."""
    a, b, _ = matmul_operands(gen, m, k, n, logits=logits)
    tol = TOL_FP32 if a.dtype == torch.float32 else TOL_BF16
    want = matmul_mcast_plain(a, b)  # the one function all three compute
    plain_ms = time_ms(lambda: matmul_mcast_plain(a, b))[0]
    b_ms, b_by = matmul_bound(a, b, None, a.dtype)
    library, lib_ms = matmul_library(a, b)
    blocks = kernel_blocks(m)
    cluster = resident = None
    if m > 64:  # K4's cluster size by its C rule, as kernel_blocks reports it
        k4 = _build.load("matmul_mcast")
        cluster, resident = k4.matmul_mcast_cluster(m), k4.matmul_mcast_active_clusters(m)
        if 128 * cluster != blocks["mcast"]["bm"]:
            raise AssertionError(f"matmul_mcast {m}x{k}x{n}: cluster {cluster} x 128 rows "
                                 f"!= kernel_blocks bm {blocks['mcast']['bm']}")
    rec = dict(check="schedules", shape=[m, k, n], a_dtype=str(a.dtype), b_dtype=str(b.dtype),
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, blocks=blocks,
               mcast_cluster=cluster, mcast_clusters_resident=resident)
    out = {}
    for sched, fn in zip(POLICIES, (matmul_tiled, matmul_mcast, matmul_unicast)):
        before = fn.launches
        got = fn(a, b)
        assert fn.launches == before + 1, sched
        design = expect_design(fn.__name__, m, k, n, logits)
        err = check_close(f"{fn.__name__} {m}x{k}x{n}", got, want, tol)
        k_ms, k_host = time_ms(lambda: fn(a, b))
        traffic = hbm_traffic_model(m, n, k, dtype_bytes=b.element_size(), **blocks[sched])
        # how often the kernel requests each B element from global memory
        reads = -(-m // blocks[sched]["bm"])
        rec.update({f"{sched}_design": design, f"{sched}_ms": k_ms,
                    f"{sched}_b_bytes": traffic[f"{sched}_b_bytes"],
                    f"{sched}_b_reads": reads, f"{sched}_max_err": err})
        if sched != "tiled":
            out[fn.__name__] = dict(
                check="kernel", name=fn.__name__, shape=[m, k, n], a_dtype=str(a.dtype),
                b_dtype=str(b.dtype), out_dtype=str(got.dtype), design=design,
                kernel_ms=k_ms, host_ms=k_host, plain_ms=plain_ms, library=library,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_err=err, tol=tol)
            if fn is matmul_mcast:
                out[fn.__name__].update(cluster=cluster, clusters_resident=resident,
                                        b_reads=reads)
            emit(out[fn.__name__])
    emit(rec)
    return out


# V is drawn 8x wider than K, so that attention outputs are O(1) and a
# dropped page, a wrong mask or a lost partial moves elements near 0 by
# many times TOL_BF16 (tests/_paged_faults.py plants such faults)
V_SCALE = 8.0


def _pool(gen, kvh, b, n, ps, d, quant=False, dtype=torch.bfloat16):
    """A page pool with a distinct page chain per sequence (page 0 null)."""
    shape = (kvh, 1 + b * n, ps, d)
    if quant:
        k = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)
        ks = (torch.rand(*shape[:3], 1, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        vs = (torch.rand(*shape[:3], 1, device="cuda", generator=gen) * 0.02 * V_SCALE).to(
            torch.bfloat16)
        return k, v, ks, vs
    k = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return k, (torch.randn(shape, device="cuda", generator=gen) * V_SCALE).to(dtype), None, None


def _sdpa_over_pages(q, k_pages, v_pages, table, start, lengths, k_scale=None, v_scale=None):
    """The library yardstick: scaled_dot_product_attention over the K/V
    gathered from the pages (gather outside the timed call)."""
    b, s, h, d = q.shape
    kvh = k_pages.shape[0]
    k = gather_pages(k_pages, table)
    v = gather_pages(v_pages, table)
    if k_scale is not None:
        k = (k.float() * gather_pages(k_scale, table).float()).to(torch.bfloat16)
        v = (v.float() * gather_pages(v_scale, table).float()).to(torch.bfloat16)
    t = k.shape[1]
    k = k.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(h // kvh, dim=1)
    qpos = start.long()[:, None] + torch.arange(s, device=q.device)[None]
    kpos = torch.arange(t, device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) \
        & (kpos[None, None, :] < lengths.long()[:, None, None])
    qh = q.permute(0, 2, 1, 3)
    mask = mask[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def _attn_work(start, lengths, s, ps, kvh, h, d, kv_bytes, scale_bytes=0):
    """Bytes and flops this data needs: each (sequence, kv head)'s live K/V
    pages — below its length and up to the causal bound of its last query
    row — read once, whatever a kernel reads again; and QK + PV over the
    (row, key) pairs that are valid."""
    nbytes, flops = 0.0, 0.0
    for st, ln in zip(start.tolist(), lengths.tolist()):
        if ln <= 0:
            continue
        pages = min(-(-ln // ps), (st + s - 1) // ps + 1)
        nbytes += kvh * pages * ps * (2 * d * kv_bytes + 2 * scale_bytes)
        for t in range(s):
            keys = min(ln, st + t + 1)
            flops += 4.0 * h * keys * d
    return nbytes, flops


def _paged_design(fn, dtype) -> str:
    """The design ``fn`` ran, which must be the tensor-core / split-KV one
    for bf16 and int8 pools and ``cuda-core`` for fp32 ones."""
    want = "cuda-core" if dtype == torch.float32 else (
        "split-kv" if fn is paged_attention_decode else "wgmma")
    if fn.design != want:
        raise AssertionError(f"{fn.__name__}: design {fn.design!r} ran for {dtype} pools, "
                             f"expected {want!r}")
    return fn.design


def decode_case(gen, *, b=4, h=16, kvh=16, d=64, ps=16, n=16, lengths=(256, 200, 37, 129),
                dtype=torch.bfloat16):
    """K2's inputs: q, pools, table, start, lengths (a decode token each)."""
    kp, vp, _, _ = _pool(gen, kvh, b, n, ps, d, dtype=dtype)
    table = torch.arange(1, 1 + b * n, device="cuda", dtype=torch.int32).reshape(b, n)
    lengths = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    q = torch.randn(b, h, d, device="cuda", generator=gen).to(dtype)
    return q, kp, vp, table, lengths - 1, lengths


def prefill_case(gen, *, b=1, s=16, h=16, kvh=16, d=64, ps=16, n=16, lengths=(48,),
                 quant=False, dtype=torch.bfloat16):
    """K3's inputs: q, pools, table, start, lengths and the int8 scales
    (the last s tokens of each sequence)."""
    kp, vp, ks, vs = _pool(gen, kvh, b, n, ps, d, quant=quant, dtype=dtype)
    table = torch.arange(1, 1 + b * n, device="cuda", dtype=torch.int32).reshape(b, n)
    lengths = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    return q, kp, vp, table, torch.clamp(lengths - s, min=0), lengths, \
        dict(k_scale=ks, v_scale=vs)


def check_decode(gen, *, label="", b=4, h=16, kvh=16, d=64, ps=16, n=16,
                 lengths=(256, 200, 37, 129), dtype=torch.bfloat16, runs=25):
    q, kp, vp, table, start, lengths = decode_case(gen, b=b, h=h, kvh=kvh, d=d, ps=ps, n=n,
                                                   lengths=lengths, dtype=dtype)
    before = paged_attention_decode.launches
    got = paged_attention_decode(q, kp, vp, table, start, lengths)
    assert paged_attention_decode.launches == before + 1
    design = _paged_design(paged_attention_decode, dtype)
    want = paged_attention_decode_plain(q, kp, vp, table, start, lengths)
    tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
    err = check_close(f"paged_attention_decode kvh={kvh} b={b} {dtype}", got, want, tol)
    kv_bytes, flops = _attn_work(start, lengths, 1, ps, kvh, h, d, kp.element_size())
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + table.numel() * 4 + 2 * b * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32 if dtype == torch.float32 else PEAK_BF16)
    k_ms, k_host = time_ms(lambda: paged_attention_decode(q, kp, vp, table, start, lengths),
                           runs=runs)
    rec = dict(check="kernel", name="paged_attention_decode", row=label, design=design,
               splits=_decode_splits(_DTYPE_CODES[dtype], b, kvh, ps, d, n), b=b, h=h,
               kvh=kvh, d=d, ps=ps, dtype=str(dtype).split(".")[-1], pages_per_seq=n,
               lengths=lengths.tolist(), kernel_ms=k_ms, host_ms=k_host,
               plain_ms=time_ms(lambda: paged_attention_decode_plain(q, kp, vp, table, start,
                                                                     lengths), runs=runs)[0],
               library="scaled_dot_product_attention over gathered pages",
               library_ms=time_ms(_sdpa_over_pages(q[:, None], kp, vp, table, start,
                                                   lengths), runs=runs)[0],
               kernel_ms_clean_l2=time_ms(lambda: paged_attention_decode(
                   q, kp, vp, table, start, lengths), runs=runs, clean_l2=True)[0],
               library_ms_clean_l2=time_ms(_sdpa_over_pages(
                   q[:, None], kp, vp, table, start, lengths), runs=runs, clean_l2=True)[0],
               bound_ms=b_ms, bound_by=b_by, max_err=err, tol=tol)
    emit(rec)
    return rec


def check_prefill(gen, *, label="", b=1, s=16, h=16, kvh=16, d=64, ps=16, n=16,
                  lengths=(48,), quant=False, dtype=torch.bfloat16, runs=25):
    q, kp, vp, table, start, lengths, kw = prefill_case(
        gen, b=b, s=s, h=h, kvh=kvh, d=d, ps=ps, n=n, lengths=lengths, quant=quant, dtype=dtype)
    ks, vs = kw["k_scale"], kw["v_scale"]
    before = paged_attention_prefill.launches
    got = paged_attention_prefill(q, kp, vp, table, start, lengths, **kw)
    assert paged_attention_prefill.launches == before + 1
    design = _paged_design(paged_attention_prefill, dtype)
    want = paged_attention_prefill_plain(q, kp, vp, table, start, lengths, **kw)
    tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
    err = check_close(f"paged_attention_prefill s={s} quant={quant} {dtype}", got, want, tol)
    kv_bytes, flops = _attn_work(start, lengths, s, ps, kvh, h, d, kp.element_size(),
                                 2 if quant else 0)
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + table.numel() * 4 + 2 * b * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_FP32 if dtype == torch.float32 else PEAK_BF16)
    k_ms, k_host = time_ms(lambda: paged_attention_prefill(q, kp, vp, table, start, lengths,
                                                           **kw), runs=runs)
    group = h // kvh
    qc = prefill_chunk(s, group)
    rec = dict(check="kernel", name="paged_attention_prefill", row=label, design=design,
               splits=_prefill_splits(_DTYPE_CODES[dtype], _DTYPE_CODES[kp.dtype], b, s, qc, h,
                                      kvh, ps, d, n),
               b=b, s=s, h=h, kvh=kvh, d=d, ps=ps, dtype=str(dtype).split(".")[-1],
               pages_per_seq=n, lengths=lengths.tolist(), int8=quant,
               kernel_ms=k_ms, host_ms=k_host,
               plain_ms=time_ms(lambda: paged_attention_prefill_plain(q, kp, vp, table, start,
                                                                      lengths, **kw),
                                runs=runs)[0],
               library="scaled_dot_product_attention over gathered pages",
               library_ms=time_ms(_sdpa_over_pages(q, kp, vp, table, start, lengths, ks,
                                                   vs), runs=runs)[0],
               kernel_ms_clean_l2=time_ms(lambda: paged_attention_prefill(
                   q, kp, vp, table, start, lengths, **kw), runs=runs, clean_l2=True)[0],
               library_ms_clean_l2=time_ms(_sdpa_over_pages(
                   q, kp, vp, table, start, lengths, ks, vs), runs=runs, clean_l2=True)[0],
               bound_ms=b_ms, bound_by=b_by, max_err=err, tol=tol)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 2b: gradients — K6, K7, K8 and the differentiated paths
# ---------------------------------------------------------------------------


class FlashShape(NamedTuple):
    label: str
    b: int
    h: int
    kvh: int
    sq: int
    sk: int
    d: int
    dtype: torch.dtype
    causal: bool
    window: int | None
    softcap: float | None
    runs: int  # timed runs of each function


FLASH_SHAPES = (
    FlashShape("qwen1.5-0.5b", 2, 16, 16, 2048, 2048, 64, torch.bfloat16, True, None, None, 10),
    FlashShape("gemma2-9b local layer", 1, 16, 8, 8192, 8192, 256, torch.bfloat16, True, 4096,
               50.0, 3),
    FlashShape("bench_kernels flash row", 1, 4, 2, 512, 512, 64, torch.float32, True, None,
               None, 25),
    FlashShape("ragged cross", 3, 8, 1, 77, 200, 128, torch.bfloat16, False, None, None, 25),
    FlashShape("ragged, keyless rows", 3, 8, 1, 200, 77, 128, torch.bfloat16, True, 16, None,
               25),
    # a row that sees one key (causal row 0) at the smallest grid: the
    # single-key rounding rule of check_flash_close at work
    FlashShape("single-key rows", 1, 1, 1, 128, 128, 64, torch.bfloat16, True, None, None, 25),
)
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def flash_pairs(c: FlashShape) -> int:
    """The (query, key) pairs the masks keep, over all heads: the work
    this data needs (a row that sees no key needs only the mean of V)."""
    qp = np.arange(c.sq)
    lo = np.maximum(0, qp - c.window + 1) if c.window else np.zeros(c.sq, np.int64)
    hi = np.minimum(qp, c.sk - 1) if c.causal else np.full(c.sq, c.sk - 1)
    return c.b * c.h * int(np.maximum(0, hi - lo + 1).sum())


def flash_bounds(c: FlashShape) -> dict[str, tuple[float, str]]:
    """Each kernel's least time: its inputs read and outputs written once,
    against 2 d FLOPs per kept pair per product (K6 2, K7 3, K8 4
    products) at the card's peak for the operands' type."""
    es = torch.tensor([], dtype=c.dtype).element_size()
    pairs, peak = flash_pairs(c), PEAK_BF16 if c.dtype == torch.bfloat16 else PEAK_FP32
    q_bytes, kv_bytes = c.b * c.h * c.sq * c.d * es, c.b * c.kvh * c.sk * c.d * es
    rows = c.b * c.h * c.sq * 4  # one fp32 per query row: lse, delta
    return {
        "flash_attention": bound(2 * 2 * c.d * pairs, 2 * q_bytes + 2 * kv_bytes + rows, peak),
        "flash_attention_bwd_dq": bound(3 * 2 * c.d * pairs,
                                        3 * q_bytes + 2 * kv_bytes + 2 * rows, peak),
        "flash_attention_bwd_dkv": bound(4 * 2 * c.d * pairs,
                                         2 * q_bytes + 2 * kv_bytes + 2 * rows
                                         + 2 * c.b * c.h * c.sk * c.d * es, peak),
    }


def single_key_rounding(c: FlashShape, q, k, v, do) -> dict[str, tuple | None]:
    """The outputs that are rounding, not signal, with their bound.

    A row that sees exactly one key has p = 1 and dS = dP - delta: two
    fp32 sums of the same d exact products dO·v, so its dS, and its dQ,
    are 0 in exact arithmetic and each implementation returns its own
    rounding (the plain version's row is often exactly 0, where the
    row-RMS allowance has no width).  Each sum errs by at most d 2^-24
    sum|dO v|, so |dQ_row| <= 2 d 2^-24 sum|dO v| |k| scale (x 1.01 for
    the bf16 rounding of dS).  A key fed only by such rows gets dK from
    those dS alone: the sum over its rows of the same bound times |q|.
    Returns {"dq": (rows, bound), "dk": (keys, bound per query head)},
    an entry None where no row or key is of that kind (``tests/
    test_torch_cuda.py`` ``_dq_close`` holds the card tests' rows so)."""
    mask = _mask(c.sq, c.sk, c.causal, c.window, "cuda")
    one = mask.sum(dim=-1) == 1
    group, unit = c.h // c.kvh, 2 * c.d * 2.0**-24 / math.sqrt(c.d) * 1.01
    out = {"dq": None, "dk": None}
    if bool(one.any()):
        key = mask.float().argmax(dim=-1)[one]
        kc = k[:, :, key].repeat_interleave(group, dim=1).float()
        vc = v[:, :, key].repeat_interleave(group, dim=1).float()
        terms = (do[:, :, one].float().abs() * vc.abs()).sum(dim=-1, keepdim=True)
        out["dq"] = (one, unit * terms * kc.abs())
    keys = mask.any(dim=0) & ~(mask & ~one[:, None]).any(dim=0)
    if bool(keys.any()):
        rows = (mask & one[:, None] & keys[None, :]).any(dim=1)
        hit = mask[rows][:, keys].float()                          # (rows, keys)
        vh = v[:, :, keys].repeat_interleave(group, dim=1).float()
        terms = do[:, :, rows].float().abs() @ vh.abs().transpose(-1, -2) * hit
        out["dk"] = (keys, unit * terms.transpose(-1, -2) @ q[:, :, rows].float().abs())
    return out


def flash_fp64_grads(c: FlashShape, q, k, v, do) -> list[torch.Tensor]:
    """dQ, dK and dV of sum(attention(q, k, v) * do) in fp64 autograd, one
    kv head's group of query heads at a time (dK and dV summed over the
    group in fp64)."""
    g = c.h // c.kvh
    mask = _mask(c.sq, c.sk, c.causal, c.window, "cuda")
    out = [torch.zeros_like(t, dtype=torch.float64) for t in (q, k, v)]
    for hk in range(c.kvh):
        qs = q[:, hk * g:(hk + 1) * g].double().requires_grad_()
        ks = k[:, hk:hk + 1].double().requires_grad_()
        vs = v[:, hk:hk + 1].double().requires_grad_()
        s = qs @ ks.transpose(-1, -2) / math.sqrt(c.d)
        if c.softcap is not None:
            s = c.softcap * torch.tanh(s / c.softcap)
        o = torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ vs
        grads = torch.autograd.grad((o * do[:, hk * g:(hk + 1) * g].double()).sum(),
                                    [qs, ks, vs])
        for dst, (lo, hi), grad in zip(out, ((hk * g, (hk + 1) * g), (hk, hk + 1),
                                             (hk, hk + 1)), grads):
            dst[:, lo:hi] = grad
        del s, o, grads
    return out


def check_fp64_distance(name: str, got, plain, ref, tol: float, rounding=None) -> tuple:
    """The kernel's and the plain version's largest ratio (:func:`flash_ratios`)
    against an fp64 reference ``ref``; fails where the kernel's passes 1
    and the plain version's own.  Returns both ratios."""
    torch.cuda.synchronize()
    ratios = [float(flash_ratios(t, ref, tol, rounding).max()) for t in (got, plain)]
    if not ratios[0] <= max(1.0, ratios[1]):
        raise AssertionError(f"{name}: the kernel is {ratios[0]:.3g} x the allowance from the "
                             f"fp64 reference, the plain version {ratios[1]:.3g}")
    return tuple(ratios)


def _sdpa(c: FlashShape):
    """One SDPA call computing K6's function, or None: a window or a
    softcap is not SDPA's (its causal mask, top-left aligned, is ours)."""
    if c.window is not None or c.softcap is not None:
        return None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if c.h == c.kvh:
        return lambda q, k, v: sdpa(q, k, v, is_causal=c.causal)
    return lambda q, k, v: sdpa(q, k, v, is_causal=c.causal, enable_gqa=True)


def _sdpa_backward(c: FlashShape, q, k, v, do):
    """One aten call computing K7's and K8's functions together — dQ, dK
    and dV from a saved forward and log-sum-exp (FlashAttention-2's
    backward) — or None where that kernel does not take the case (GQA,
    fp32, a window or a softcap).  Its forward runs here, untimed."""
    if _sdpa(c) is None or c.h != c.kvh or c.dtype != torch.bfloat16:
        return None
    aten = torch.ops.aten
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, c.causal)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, c.causal, seed, offset)


def _flash_inputs(gen, c: FlashShape):
    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(c.dtype)
    return (rand(c.b, c.h, c.sq, c.d), rand(c.b, c.kvh, c.sk, c.d), rand(c.b, c.kvh, c.sk, c.d),
            rand(c.b, c.h, c.sq, c.d))


def check_flash(gen, c: FlashShape) -> dict[str, dict]:
    """K6, K7 and K8 against their plain versions on the same inputs
    (the backward ones fed K6's lse and delta), each timed."""
    q, k, v, do = _flash_inputs(gen, c)
    kw = dict(causal=c.causal, window=c.window, softcap=c.softcap)
    tol = TOL_BF16 if c.dtype == torch.bfloat16 else TOL_FP32
    before = kernels.launch_counts()
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    o_p, lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)
    errs = {"flash_attention": check_flash_close(f"flash_attention {c.label}", o, o_p, tol)}
    check_close(f"flash_attention lse {c.label}", lse, lse_p, TOL_FP32)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta)
    rounding = single_key_rounding(c, q, k, v, do)
    errs["flash_attention_bwd_dq"] = check_flash_close(
        f"flash_attention_bwd_dq {c.label}", flash_attention_bwd_dq(*bwd, **kw),
        flash_attention_bwd_dq_plain(*bwd, **kw), tol, rounding["dq"])
    (dk, dv), (dk_p, dv_p) = flash_attention_bwd_dkv(*bwd, **kw), \
        flash_attention_bwd_dkv_plain(*bwd, **kw)
    dkv_errs = (check_flash_close(f"flash_attention_bwd_dkv dk {c.label}", dk, dk_p, tol,
                                  rounding["dk"]),
                check_flash_close(f"flash_attention_bwd_dkv dv {c.label}", dv, dv_p, tol))
    errs["flash_attention_bwd_dkv"] = tuple(map(max, zip(*dkv_errs)))
    after = kernels.launch_counts()
    assert all(after[n] == before[n] + 1 for n in FLASH_KERNELS), (before, after)
    del o_p, lse_p, dk_p, dv_p
    designs = {n: kernels.KERNELS[n].design for n in FLASH_KERNELS}
    core = "wgmma" if c.dtype == torch.bfloat16 and c.d % 8 == 0 else "cuda-core"
    if designs != dict.fromkeys(FLASH_KERNELS, core):
        raise AssertionError(f"flash {c.label}: designs {designs}, expected K6-K8 {core}")

    warm = 1 if c.runs < 10 else 3
    timed = {
        "flash_attention": (lambda: flash_attention(q, k, v, return_lse=True, **kw),
                            lambda: flash_attention_plain(q, k, v, return_lse=True, **kw)),
        "flash_attention_bwd_dq": (lambda: flash_attention_bwd_dq(*bwd, **kw),
                                   lambda: flash_attention_bwd_dq_plain(*bwd, **kw)),
        "flash_attention_bwd_dkv": (lambda: flash_attention_bwd_dkv(*bwd, **kw),
                                    lambda: flash_attention_bwd_dkv_plain(*bwd, **kw)),
    }
    sdpa, sdpa_bwd = _sdpa(c), _sdpa_backward(c, q, k, v, do)
    library = {"flash_attention": ("scaled_dot_product_attention", sdpa and
                                   (lambda: sdpa(q, k, v)))}
    for name in FLASH_KERNELS[1:]:  # one call computes dQ, dK and dV: K7 and K8 jointly
        library[name] = ("aten._scaled_dot_product_flash_attention_backward (dQ, dK, dV "
                         "jointly)", sdpa_bwd)
    lib_ms = {fn: time_ms(fn, c.runs, warm)[0] for _, fn in library.values() if fn}
    bounds = flash_bounds(c)
    recs = {}
    for name, (fn, plain) in timed.items():
        k_ms, k_host = time_ms(fn, c.runs, warm)
        b_ms, b_by = bounds[name]
        lib_name, lib_fn = library[name]
        recs[name] = dict(
            check="kernel", name=name, case=c.label, b=c.b, h=c.h, kvh=c.kvh, sq=c.sq, sk=c.sk,
            d=c.d, dtype=str(c.dtype), causal=c.causal, window=c.window, softcap=c.softcap,
            design=designs[name], kept_pairs=flash_pairs(c), kernel_ms=k_ms, host_ms=k_host,
            plain_ms=time_ms(plain, c.runs, warm)[0],
            library=lib_name if lib_fn else None, library_ms=lib_ms.get(lib_fn),
            bound_ms=b_ms, bound_by=b_by, max_err=errs[name][0], err_over_allowance=errs[name][1],
            least_fixed_atol=errs[name][2], tol=f"{tol} x (|want| + row rms)",
            single_key_rows=0 if rounding["dq"] is None else int(rounding["dq"][0].sum()),
            single_key_only_keys=0 if rounding["dk"] is None else int(rounding["dk"][0].sum()))
        if name == "flash_attention_bwd_dkv":
            recs[name]["err_over_allowance_dk_dv"] = [e[1] for e in dkv_errs]
        emit(recs[name])
    return recs


def check_flash_path(gen, c: FlashShape) -> dict[str, int]:
    """The differentiated path: ``torch.autograd.grad`` of
    ``(op("flash_attention")(q, k, v).float() * w).sum()`` with respect to
    q, k and v, every launch count set to 0 just before and read just
    after, against the same graph on the plain versions; then timed
    beside SDPA's forward + backward where SDPA computes the function."""
    q, k, v, _ = _flash_inputs(gen, c)
    w = torch.randn(c.b, c.h, c.sq, c.d, device="cuda", generator=gen)
    kw = dict(causal=c.causal, window=c.window, softcap=c.softcap)
    fa = kernels.op("flash_attention")

    def path():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fa(*leaves, **kw)
        return (out, *torch.autograd.grad((out.float() * w).sum(), leaves))

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    out = fa(*leaves, **kw)
    fwd = kernels.launch_counts()
    grads = torch.autograd.grad((out.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    bwd = {n: total[n] - fwd[n] for n in total}
    if fwd["flash_attention"] != 1 or sum(fwd.values()) != 1 \
            or bwd["flash_attention_bwd_dq"] != 1 or bwd["flash_attention_bwd_dkv"] != 1 \
            or sum(bwd.values()) != 2:
        raise AssertionError(f"flash path {c.label}: forward launched {fwd}, backward {bwd}")
    with plain_versions():
        want = path()
    tol = TOL_BF16 if c.dtype == torch.bfloat16 else TOL_FP32
    # the path's dO is w in the output's dtype; dK is summed over each kv
    # head's group of query heads
    rounding = single_key_rounding(c, q, k, v, w.to(c.dtype))
    if rounding["dk"] is not None:
        keys, bnd = rounding["dk"]
        rounding["dk"] = (keys, bnd.unflatten(1, (c.kvh, c.h // c.kvh)).sum(dim=2))
    rules = (None, rounding["dq"], rounding["dk"], None)
    errs = [check_flash_close(f"flash path {c.label} {name}", got, ref, tol, rule)
            for name, got, ref, rule in zip(("o", "dq", "dk", "dv"), (out, *grads), want, rules)]
    # dK and dV against fp64 as well, on the dO the path feeds both sides
    # (w in the output's dtype): each side rounds every query head's share
    # to the dtype before the group sum, so neither is the other's truth
    ref = flash_fp64_grads(c, q, k, v, w.to(c.dtype))
    fp64 = [check_fp64_distance(f"flash path {c.label} {name} vs fp64", got, plain, r, tol,
                                rule)
            for name, got, plain, r, rule in zip(("dk", "dv"), grads[1:], want[2:], ref[1:],
                                                 rules[2:])]
    del want, ref
    warm = 1 if c.runs < 10 else 3
    sdpa = _sdpa(c)

    def sdpa_path():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = sdpa(*leaves)
        return torch.autograd.grad((o.float() * w).sum(), leaves)

    k_ms, k_host = time_ms(path, c.runs, warm, max_spin_s=0.5)
    with plain_versions():
        plain_ms = time_ms(path, c.runs, warm, max_spin_s=0.5)[0]
    emit(dict(check="grad_path", case=c.label, b=c.b, h=c.h, kvh=c.kvh, sq=c.sq, sk=c.sk, d=c.d,
              dtype=str(c.dtype), causal=c.causal, window=c.window, softcap=c.softcap,
              forward_launches={n: v for n, v in fwd.items() if v},
              backward_launches={n: v for n, v in bwd.items() if v},
              fwd_bwd_ms=k_ms, host_ms=k_host, plain_fwd_bwd_ms=plain_ms,
              library="scaled_dot_product_attention forward + backward" if sdpa else None,
              library_fwd_bwd_ms=None if sdpa is None else time_ms(sdpa_path, c.runs, warm)[0],
              max_err_o_dq_dk_dv=[e[0] for e in errs],
              err_over_allowance_o_dq_dk_dv=[e[1] for e in errs],
              least_fixed_atol_o_dq_dk_dv=[e[2] for e in errs],
              fp64_over_allowance_dk_dv=[r[0] for r in fp64],
              plain_fp64_over_allowance_dk_dv=[r[1] for r in fp64],
              tol=f"{tol} x (|want| + row rms)"))
    return total


def check_linear_grad(gen, policy: str, m: int = 4096, k: int = 1024, n: int = 2816) -> None:
    """``grad(linear)`` with bias and silu (qwen's gate projection over
    2 x 2048 tokens) under a forced schedule: one matmul launch forward,
    then z, dA and dB backward, each on K1's ``wgmma`` design.  Each
    backward launch is held against its plain version on its own inputs,
    and the gradients against the same graph on the plain versions.

    The backward rounds dz to bf16 before the dA and dB products, and z
    comes from an fp32 product whose last bits depend on the summation
    order: where dz lies near a bf16 rounding boundary, the kernel run and
    the plain run round it to neighbouring values (about 5,800 of 11.5 M
    elements at this shape on an H100), and a dB element sums 4,096 such
    terms.  So dA and dB are held to TOL_BF16 plus the exact effect of the
    elements of bf16 dz in which the two runs differ, |Δdz| |B|ᵀ and |A|ᵀ
    |Δdz| (zero wherever they agree)."""
    a = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    b = (torch.randn(k, n, device="cuda", generator=gen) / math.sqrt(k)).to(torch.bfloat16)
    bias = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(m, n, device="cuda", generator=gen)

    def path():
        leaves = [t.detach().requires_grad_() for t in (a, b, bias)]
        y = kernels.linear(leaves[0], leaves[1], bias=leaves[2], activation="silu",
                           policy=policy)
        return (y, *torch.autograd.grad((y.float() * w).sum(), leaves))

    def noting(fn, calls):
        """fn, noting each call's arguments, output and K1 design"""
        def run(*args, **kw):
            out = fn(*args, **kw)
            calls.append((args, kw, out, matmul_tiled.design if fn is matmul_tiled else None))
            return out
        return run

    leaves = [t.detach().requires_grad_() for t in (a, b, bias)]
    forced = dict(zip(POLICIES, MATMULS))[policy]
    kernels.reset_launch_counts()
    y = kernels.linear(leaves[0], leaves[1], bias=leaves[2], activation="silu", policy=policy)
    fwd = kernels.launch_counts()
    fwd_design = kernels.KERNELS[forced].design
    calls, plain_calls = [], []
    with mock.patch.object(api, "matmul_tiled", noting(matmul_tiled, calls)):
        grads = torch.autograd.grad((y.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    bwd = {name: cnt - fwd[name] for name, cnt in kernels.launch_counts().items()}
    bwd_designs = [c[3] for c in calls]
    want_fwd = "wgmma-cluster" if forced == "matmul_mcast" else "wgmma"
    if fwd[forced] != 1 or sum(fwd.values()) != 1 or sum(bwd.values()) != 3 \
            or any(bwd[name] for name in bwd if name not in MATMULS):
        raise AssertionError(f"grad(linear) {policy}: forward launched {fwd}, backward {bwd}")
    if fwd_design != want_fwd or bwd_designs != ["wgmma"] * 3:
        raise AssertionError(f"grad(linear) {policy}: forward design {fwd_design}, backward "
                             f"K1 designs {bwd_designs}; expected {want_fwd}, then wgmma x 3")
    launch_errs = [check_close(f"grad(linear) {policy} {name} launch", out,
                               matmul_tiled_plain(*args, **kw),
                               TOL_FP32 if out.dtype == torch.float32 else TOL_BF16)
                   for name, (args, kw, out, _) in zip(("z", "da", "db"), calls)]
    with plain_versions(), mock.patch.object(api, "matmul_tiled",
                                             noting(matmul_tiled_plain, plain_calls)):
        want = path()
    # bf16 dz, the first operand of the dA product, in each run
    flips = (calls[1][0][0].double() - plain_calls[-2][0][0].double()).abs()
    flips_n = int((flips > 0).sum())
    extra = {"da": flips @ b.double().abs().t(), "db": a.double().abs().t() @ flips}
    errs, ratios = [], []
    for name, got, ref in zip(("y", "da", "db", "dbias"), (y, *grads), want):
        errs.append(check_close(f"grad(linear) {policy} {name}", got, ref, TOL_BF16,
                                extra.get(name)))
        allow = TOL_BF16 * (1 + ref.detach().float().abs()) + extra.get(name, 0.0)
        ratios.append(float(((got.detach().float() - ref.detach().float()).abs() / allow).max()))
    del extra, flips
    k_ms, k_host = time_ms(path, 10, max_spin_s=0.5)
    with plain_versions():
        plain_ms = time_ms(path, 10, max_spin_s=0.5)[0]
    emit(dict(check="linear_grad", policy=policy, shape=[m, k, n], activation="silu", bias=True,
              forward_launches={n_: v for n_, v in fwd.items() if v},
              backward_launches={n_: v for n_, v in bwd.items() if v},
              forward_design=fwd_design, backward_designs=bwd_designs,
              fwd_bwd_ms=k_ms, host_ms=k_host, plain_fwd_bwd_ms=plain_ms,
              launch_max_err_z_da_db=launch_errs, dz_bf16_elements_differing=flips_n,
              max_err_y_da_db_dbias=errs, err_over_allowance_y_da_db_dbias=ratios,
              tol=TOL_BF16))


def check_gradients(gen, summary: dict) -> dict[str, int]:
    """Phase 2b; returns each kernel's launches over the two autograd
    path runs (the main path of K6, K7 and K8)."""
    for i, c in enumerate(FLASH_SHAPES):
        recs = check_flash(gen, c)
        if i == 0:  # the kernels line reports qwen1.5-0.5b's shape
            summary.update(recs)
    launches = dict.fromkeys(kernels.KERNELS, 0)
    for c in FLASH_SHAPES[:2]:  # the two full-width shapes
        for name, cnt in check_flash_path(gen, c).items():
            launches[name] += cnt
    for policy in POLICIES:
        check_linear_grad(gen, policy)
    return launches


# ---------------------------------------------------------------------------
# phase 2c: scans — K9, K10, K11, K12 and their differentiated paths
# ---------------------------------------------------------------------------


class SsdShape(NamedTuple):
    label: str
    b: int
    h: int
    s: int
    p: int
    n: int
    slow_decay: bool  # mamba2's dt and A: log a in [-0.1, -0.001]
    runs: int


class LruShape(NamedTuple):
    label: str
    b: int
    s: int
    d: int
    slow_decay: bool  # log a uniform in [-0.1, -1e-4]: carries that outlive many chunks
    runs: int


SSD_SHAPES = (
    # d_model 1536 x expand 2 = 48 heads of P 64, d_state 128
    SsdShape("mamba2-780m", 2, 48, 2048, 64, 128, True, 10),
    SsdShape("bench_kernels ssd row", 1, 4, 1024, 64, 64, False, 25),
    SsdShape("ragged", 1, 3, 200, 32, 16, False, 25),  # s: no divisor in 32..256
    SsdShape("wide state", 1, 2, 256, 64, 1024, False, 25),  # a 256 KB fp32 state
)
LRU_SHAPES = (
    LruShape("recurrentgemma-2b", 2, 2048, 2560, False, 10),  # d_rnn 2560
    # the repo's train_4k sequence length (src/repro/configs/shapes.py)
    LruShape("recurrentgemma-2b train_4k, slow decays", 2, 4096, 2560, True, 10),
    LruShape("bench_kernels rglru row", 1, 512, 512, False, 25),
    LruShape("ragged", 3, 77, 192, False, 25),  # two chunks of the kernels' 64, the last of 13
)
SCAN_KERNELS = ("ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")


def _ssd_inputs(gen, c: SsdShape):
    """xdt, B, C ~ 0.5 N(0, 1), log a = -softplus(N(0, 1)) (the JAX
    tests' draws) or uniform in [-0.1, -0.001], dy ~ N(0, 1); fp32."""
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale
    xdt, bm, cm = rand(c.b, c.h, c.s, c.p, scale=0.5), rand(c.b, c.s, c.n, scale=0.5), \
        rand(c.b, c.s, c.n, scale=0.5)
    if c.slow_decay:
        log_a = -0.001 - 0.099 * torch.rand(c.b, c.h, c.s, device="cuda", generator=gen)
    else:
        log_a = -torch.nn.functional.softplus(rand(c.b, c.h, c.s))
    return xdt, bm, cm, log_a, rand(c.b, c.h, c.s, c.p)


def _lru_inputs(gen, c: LruShape):
    """a = 0.8 + 0.2 sigmoid(N(0, 1)) (the JAX tests' draw) or exp of a
    uniform in [-0.1, -1e-4], b ~ N(0, 1), dh ~ N(0, 1); fp32."""
    def rand():
        return torch.randn(c.b, c.s, c.d, device="cuda", generator=gen)
    if c.slow_decay:
        a = torch.exp(-1e-4 - (0.1 - 1e-4) * torch.rand(c.b, c.s, c.d, device="cuda",
                                                         generator=gen))
    else:
        a = 0.8 + 0.2 * torch.sigmoid(rand())
    return a, rand(), rand()


SSD_DESIGN = "chunk-parallel"  # the design every SSD_SHAPES row must run
LRU_DESIGN = "chunked-lookback"  # the design every LRU_SHAPES row must run


def ssd_bounds(c: SsdShape, peak: float = PEAK_FP32_ACCURATE) -> dict[str, tuple[float, str]]:
    """K9 and K10's least times: the recurrence's own flops — 4 P N a step
    a head forward (state update and readout), 12 backward (the carried
    adjoint, dxdt, dB, dC, d log a and the recomputed state) — whatever
    the chunk, against each input read and each output written once.
    The flops are taken at ``peak``: by default the card's rate for
    fp32-accurate products, PEAK_TF32 / 3 (165 TFLOP/s), since the
    kernels run them on the tensor cores in 3xTF32 and can go below a
    bound taken at the fp32 rate outside them (PEAK_FP32, the bound of
    the earlier CUDA-core kernels, reported beside it)."""
    steps, nc = c.b * c.h * c.s, -(-c.s // SSD_CHUNK)
    x_bytes, bc_bytes, l_bytes = steps * c.p * 4, 2 * c.b * c.s * c.n * 4, steps * 4
    states = c.b * c.h * nc * c.p * c.n * 4
    return {
        "ssd_scan": bound(4.0 * c.p * c.n * steps, 2 * x_bytes + bc_bytes + l_bytes, peak),
        "ssd_scan_bwd": bound(12.0 * c.p * c.n * steps,
                              3 * x_bytes + bc_bytes + 2 * l_bytes + states
                              + 2 * steps * c.n * 4, peak),
    }


def lru_bounds(c: LruShape) -> dict[str, tuple[float, str]]:
    """K11: a and b read, h written, 2 flops a step a channel; K12: a,
    h_prev and dh read, da and db written, 3 flops."""
    elems = c.b * c.s * c.d
    return {"rglru_scan": bound(2.0 * elems, 3 * elems * 4, PEAK_FP32),
            "rglru_scan_bwd": bound(3.0 * elems, 5 * elems * 4, PEAK_FP32)}


def _scan_record(name, case, shape, errs, fn, plain, bounds, runs, tol, extra=None):
    warm = 1 if runs < 10 else 3
    k_ms, k_host = time_ms(fn, runs, warm)
    b_ms, b_by = bounds[name]
    rec = dict(check="kernel", name=name, case=case, shape=shape, dtype="torch.float32",
               **(extra or {}), kernel_ms=k_ms, host_ms=k_host,
               # a plain recurrence enqueues thousands of small ops: a longer
               # spin keeps the events on device work
               plain_ms=time_ms(plain, runs, warm, max_spin_s=0.2)[0],
               library=None, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               max_err=errs[0], err_over_allowance=errs[1], least_fixed_atol=errs[2],
               tol=f"{tol} x (|want| + row rms)")
    emit(rec)
    return rec


def _worst(*errs):
    return tuple(map(max, zip(*errs)))


def ssd_fp64(xdt, bm, cm, lcum, dy):
    """The SSD scan evaluated in fp64 — the plain version's chunked
    arithmetic, every product and sum in fp64 — and its gradients by
    autograd: y, the chunk-initial states, dxdt, dB and dC per head (each
    head reads its own copy of B and C), d log a per step.  The witness
    for both sides of a K9/K10 check: where C_i . B_j cancels to a small
    part of its terms, an fp32 sum moves it by more than TOL_SCAN's
    allowance, so the plain fp32 version can miss the exact value too."""
    bsz, h, s, p = xdt.shape
    n, q = bm.shape[-1], SSD_CHUNK
    nc = -(-s // q)
    lc = lcum[..., 0].double()  # the per-step log-decays: its differences inside a chunk
    la = torch.cat([lc[..., :1], lc[..., 1:] - lc[..., :-1]], dim=-1)
    la[..., ::q] = lc[..., ::q]
    x, la = xdt.double().requires_grad_(), la.requires_grad_()
    b_h, c_h = (m.double()[:, None].expand(bsz, h, s, n).clone().requires_grad_()
                for m in (bm, cm))

    def chunks(t):  # (b, h, s, k) -> (b, h, nc, q, k), zero steps appended
        return torch.nn.functional.pad(t, (0, 0, 0, nc * q - s)).reshape(bsz, h, nc, q, -1)
    xc, bc, cc = chunks(x), chunks(b_h), chunks(c_h)
    l = chunks(la[..., None])[..., 0].cumsum(-1)
    causal = torch.ones(q, q, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.exp(torch.where(causal, l[..., :, None] - l[..., None, :], -torch.inf))
    y = (decay * (cc @ bc.transpose(-1, -2))) @ xc
    ltot = l[..., -1]
    fresh = (xc * torch.exp(ltot[..., None] - l)[..., None]).transpose(-1, -2) @ bc
    state, states = torch.zeros_like(fresh[:, :, 0]), []
    for ci in range(nc):
        states.append(state)
        state = torch.exp(ltot[:, :, ci])[..., None, None] * state + fresh[:, :, ci]
    st = torch.stack(states, dim=2)
    y = y + torch.exp(l)[..., None] * (cc @ st.transpose(-1, -2))
    y = y.reshape(bsz, h, nc * q, p)[:, :, :s]
    grads = torch.autograd.grad((y * dy.double()).sum(), (x, b_h, c_h, la))
    return (y.detach(), st.detach(), *grads)


def cuda_launches(fn, prefix: str, traces: int = 3, lead: int = 32) -> int | None:
    """The CUDA kernels whose names hold ``prefix`` that one call of ``fn``
    launches, read from ``torch.profiler`` traces of one call each, the
    most that any of ``traces`` traces shows (a trace never shows extra
    ones).  A trace here can lose the first kernels after it starts —
    the first two, late in a long run — so ``lead`` small kernels of
    another name open each trace.  None if no trace shows any device
    event.  The names carry their namespace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    counts = []
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1)
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            counts.append(sum(prefix in e.name for e in evs))
    return max(counts) if counts else None


def check_ssd(gen, c: SsdShape) -> dict[str, dict]:
    """K9 (with its checkpoints) and K10 against their plain versions on
    the same inputs (K10 fed K9's states), each timed beside its bound
    (and the bound at PEAK_FP32), each record naming its design, which
    must be SSD_DESIGN, and the CUDA launches one call issues (from a
    profiler trace).  Both the kernels and the plain versions are also
    held to the scan in fp64 (:func:`ssd_fp64`) at TOL_SCAN, so that a
    failure says which side missed the exact value.  No single PyTorch
    call computes a chunked scan: no library time."""
    xdt, bm, cm, log_a, dy = _ssd_inputs(gen, c)
    lcum = ssd_lcum(log_a, SSD_CHUNK)
    exact = ssd_fp64(xdt, bm, cm, lcum, dy)
    before = kernels.launch_counts()
    y, st = ssd_scan(xdt, bm, cm, lcum, return_states=True)
    y_p, st_p = ssd_scan_plain(xdt, bm, cm, lcum, return_states=True)
    bwd = (xdt, bm, cm, lcum, st, dy)
    got, want = ssd_scan_bwd(*bwd), ssd_scan_bwd_plain(*bwd)
    after = kernels.launch_counts()
    outputs = {"ssd_scan": {"y": (y, y_p, exact[0]), "states": (st, st_p, exact[1])},
               "ssd_scan_bwd": {name: (g, w, x) for name, g, w, x in zip(
                   ("dx", "db", "dc", "dl"), (*got[:3], got[3][..., 0]),
                   (*want[:3], want[3][..., 0]), exact[2:])}}
    errs, fp64 = {}, {}
    for kernel, outs in outputs.items():
        plain_vs_fp64 = [check_flash_close(f"{kernel} {o} {c.label}: plain version vs fp64",
                                           w, x, TOL_SCAN)[1] for o, (_, w, x) in outs.items()]
        kernel_vs_fp64 = [check_flash_close(f"{kernel} {o} {c.label}: kernel vs fp64",
                                            g, x, TOL_SCAN)[1] for o, (g, _, x) in outs.items()]
        errs[kernel] = _worst(*(check_flash_close(f"{kernel} {o} {c.label}", g, w, TOL_SCAN)
                                for o, (g, w, _) in outs.items()))
        fp64[kernel] = dict(err_over_allowance_fp64=max(kernel_vs_fp64),
                            plain_err_over_allowance_fp64=max(plain_vs_fp64))
    del y, y_p, st_p, got, want, exact, outputs
    assert all(after[n] == before[n] + 1 for n in SCAN_KERNELS[:2]), (before, after)
    designs = {n: kernels.KERNELS[n].design for n in SCAN_KERNELS[:2]}
    if designs != dict.fromkeys(SCAN_KERNELS[:2], SSD_DESIGN):
        raise AssertionError(f"ssd {c.label}: designs {designs}, expected {SSD_DESIGN}")
    bounds, shape = ssd_bounds(c), [c.b, c.h, c.s, c.p, c.n]
    fp32_bounds = ssd_bounds(c, PEAK_FP32)
    fwd, bwd_fn = (lambda: ssd_scan(xdt, bm, cm, lcum)), (lambda: ssd_scan_bwd(*bwd))
    launches = {"ssd_scan": cuda_launches(fwd, "ssd_fwd_"),
                "ssd_scan_bwd": cuda_launches(bwd_fn, "ssd_bwd_")}

    def extra(name):
        return dict(design=designs[name], cuda_launches=launches[name],
                    bound_fp32_peak_ms=fp32_bounds[name][0], **fp64[name])
    return {
        "ssd_scan": _scan_record(
            "ssd_scan", c.label, shape, errs["ssd_scan"], fwd,
            lambda: ssd_scan_plain(xdt, bm, cm, lcum), bounds, c.runs, TOL_SCAN,
            extra("ssd_scan")),
        "ssd_scan_bwd": _scan_record(
            "ssd_scan_bwd", c.label, shape, errs["ssd_scan_bwd"], bwd_fn,
            lambda: ssd_scan_bwd_plain(*bwd), bounds, c.runs, TOL_SCAN, extra("ssd_scan_bwd")),
    }


def lru_fp64(a, x, h_prev, dh):
    """The RG-LRU recurrence and its adjoint in fp64, one step at a time,
    on the fp32 inputs the kernels get: h from (a, x), and (da, db) from
    (a, h_prev, dh).  The witness for both sides of a K11/K12 check."""
    a, x, h_prev, dh = (t.double() for t in (a, x, h_prev, dh))
    h, da, db = torch.empty_like(a), torch.empty_like(a), torch.empty_like(a)
    state = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        state = a[:, t] * state + x[:, t]
        h[:, t] = state
    carry = torch.zeros_like(a[:, 0])
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + carry
        da[:, t], db[:, t] = g * h_prev[:, t], g
        carry = a[:, t] * g
    return h, da, db


def check_lru(gen, c: LruShape) -> dict[str, dict]:
    """K11 and K12 against their plain versions (K12 fed the h_prev of
    K11's output), each timed beside its bound, each record naming its
    design, which must be LRU_DESIGN, and the CUDA launches one call
    issues (from profiler traces).  Both the kernels and the plain
    versions are also held to the recurrence in fp64 (:func:`lru_fp64`) at
    TOL_SCAN, so that a failure says which side missed the exact value.
    No single PyTorch call computes a linear scan: no library time."""
    a, x, dh = _lru_inputs(gen, c)
    before = kernels.launch_counts()
    h, h_p = rglru_scan(a, x), rglru_scan_plain(a, x)
    h_prev = torch.nn.functional.pad(h[:, :-1], (0, 0, 1, 0))
    (da, db), (da_p, db_p) = rglru_scan_bwd(a, h_prev, dh), rglru_scan_bwd_plain(a, h_prev, dh)
    after = kernels.launch_counts()
    exact = lru_fp64(a, x, h_prev, dh)
    outputs = {"rglru_scan": {"h": (h, h_p, exact[0])},
               "rglru_scan_bwd": {"da": (da, da_p, exact[1]), "db": (db, db_p, exact[2])}}
    errs, fp64 = {}, {}
    for kernel, outs in outputs.items():
        plain_vs_fp64 = [check_flash_close(f"{kernel} {o} {c.label}: plain version vs fp64",
                                           w, e, TOL_SCAN)[1] for o, (_, w, e) in outs.items()]
        kernel_vs_fp64 = [check_flash_close(f"{kernel} {o} {c.label}: kernel vs fp64",
                                            g, e, TOL_SCAN)[1] for o, (g, _, e) in outs.items()]
        errs[kernel] = _worst(*(check_flash_close(f"{kernel} {o} {c.label}", g, w, TOL_SCAN)
                                for o, (g, w, _) in outs.items()))
        fp64[kernel] = dict(err_over_allowance_fp64=max(kernel_vs_fp64),
                            plain_err_over_allowance_fp64=max(plain_vs_fp64))
    del h_p, da, db, da_p, db_p, exact, outputs
    assert all(after[n] == before[n] + 1 for n in SCAN_KERNELS[2:]), (before, after)
    designs = {n: kernels.KERNELS[n].design for n in SCAN_KERNELS[2:]}
    if designs != dict.fromkeys(SCAN_KERNELS[2:], LRU_DESIGN):
        raise AssertionError(f"rglru {c.label}: designs {designs}, expected {LRU_DESIGN}")
    bounds, shape = lru_bounds(c), [c.b, c.s, c.d]
    fwd, bwd = (lambda: rglru_scan(a, x)), (lambda: rglru_scan_bwd(a, h_prev, dh))
    launches = {"rglru_scan": cuda_launches(fwd, "rglru_"),
                "rglru_scan_bwd": cuda_launches(bwd, "rglru_")}

    def extra(name):
        return dict(design=designs[name], cuda_launches=launches[name],
                    slow_decay=c.slow_decay, **fp64[name])
    return {
        "rglru_scan": _scan_record(
            "rglru_scan", c.label, shape, errs["rglru_scan"], fwd,
            lambda: rglru_scan_plain(a, x), bounds, c.runs, TOL_SCAN, extra("rglru_scan")),
        "rglru_scan_bwd": _scan_record(
            "rglru_scan_bwd", c.label, shape, errs["rglru_scan_bwd"], bwd,
            lambda: rglru_scan_bwd_plain(a, h_prev, dh), bounds, c.runs, TOL_SCAN,
            extra("rglru_scan_bwd")),
    }


def check_scan_path(label: str, family: str, inputs, plain_forward, runs: int,
                    names: tuple[str, ...]) -> dict[str, int]:
    """The differentiated path: ``torch.autograd.grad`` of
    ``(op(family)(*inputs) * w).sum()`` with respect to every input,
    every launch count set to 0 just before and read just after: one
    forward must launch the family's forward kernel once and one backward
    its backward kernel once.  Held against PyTorch's autograd through
    ``plain_forward`` — an independent derivation of the hand-written
    adjoint — then timed beside that plain path."""
    fn = kernels.op(family)
    fwd_kernel, bwd_kernel = {"ssd": SCAN_KERNELS[:2], "rglru": SCAN_KERNELS[2:]}[family]
    # both families' output has the shape of their first input (xdt, a)
    w = torch.randn(inputs[0].shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))

    def path(forward):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = forward(*leaves)
        return (out, *torch.autograd.grad((out * w).sum(), leaves))

    leaves = [t.detach().requires_grad_() for t in inputs]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    out = fn(*leaves)
    fwd = kernels.launch_counts()
    grads = torch.autograd.grad((out * w).sum(), leaves)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    bwd = {n: total[n] - fwd[n] for n in total}
    if fwd[fwd_kernel] != 1 or sum(fwd.values()) != 1 or bwd[bwd_kernel] != 1 \
            or sum(bwd.values()) != 1:
        raise AssertionError(f"{family} path {label}: forward launched {fwd}, backward {bwd}")
    want = path(plain_forward)
    # rows: the last axis — P, N or d, and the sequence for d log a (b, h, s)
    errs = [check_flash_close(f"{family} path {label} {name}", got, ref, TOL_SCAN)
            for name, got, ref in zip(names, (out, *grads), want)]
    del want
    k_ms, k_host = time_ms(lambda: path(fn), runs, max_spin_s=0.5)
    plain_ms = time_ms(lambda: path(plain_forward), max(3, runs // 3), 1, max_spin_s=0.5)[0]
    emit(dict(check="scan_grad_path", family=family, case=label,
              shapes=[list(t.shape) for t in inputs],
              forward_launches={n: v for n, v in fwd.items() if v},
              backward_launches={n: v for n, v in bwd.items() if v},
              fwd_bwd_ms=k_ms, host_ms=k_host, plain_fwd_bwd_ms=plain_ms, library=None,
              outputs=list(names), max_err=[e[0] for e in errs],
              err_over_allowance=[e[1] for e in errs],
              least_fixed_atol=[e[2] for e in errs], tol=f"{TOL_SCAN} x (|want| + row rms)"))
    return total


def _ssd_plain_forward(xdt, bm, cm, log_a):
    return ssd_scan_plain(xdt, bm, cm, ssd_lcum(log_a, SSD_CHUNK))


def check_scans(gen, summary: dict) -> dict[str, int]:
    """Phase 2c; returns each kernel's launches over the two autograd
    path runs (the main path of K9-K12)."""
    for i, c in enumerate(SSD_SHAPES):
        recs = check_ssd(gen, c)
        if i == 0:  # the kernels line reports the full-width cells
            summary.update(recs)
    for i, c in enumerate(LRU_SHAPES):
        recs = check_lru(gen, c)
        if i == 0:
            summary.update(recs)
    c = SSD_SHAPES[0]
    ssd = check_scan_path(c.label, "ssd", _ssd_inputs(gen, c)[:4], _ssd_plain_forward, c.runs,
                          ("y", "dxdt", "dB", "dC", "dlog_a"))
    c = LRU_SHAPES[0]
    lru = check_scan_path(c.label, "rglru", _lru_inputs(gen, c)[:2], rglru_scan_ref, c.runs,
                          ("h", "da", "db"))
    return {k: ssd[k] + lru[k] for k in kernels.KERNELS}


# ---------------------------------------------------------------------------
# phase 3: the full model through the kernels and through the plain versions
# ---------------------------------------------------------------------------


# a plain matmul whose B would take more fp64 bytes than this runs by
# column blocks (command-r-35b's 256,000-row head is 16.8 GB in fp64,
# beside 60.6 GB of weights)
PLAIN_FP64_BYTES = 2 << 30


def _by_columns(fn, limit: int = PLAIN_FP64_BYTES):
    """``fn(a, b[, bias], **kw)`` over column blocks of a 2-D ``b`` whose
    fp64 copy would pass ``limit`` bytes: each output column is its own
    fp64 dot product, so the blocks give the same result."""
    def run(a, b, *rest, **kw):
        if b.ndim != 2 or b.numel() * 8 <= limit:
            return fn(a, b, *rest, **kw)
        step = max(1, limit // (8 * b.shape[0]))
        bias = rest[0] if rest else None
        return torch.cat([fn(a, b[:, n0:n0 + step],
                             *((None if bias is None else bias[n0:n0 + step],) if rest else ()),
                             **kw) for n0 in range(0, b.shape[1], step)], dim=-1)
    return run


@contextlib.contextmanager
def plain_versions():
    """Route the kernel layer to the plain versions (CUDA tensors and all)
    for a reference run; the port itself has no such switch.  The plain
    matmuls run by column blocks where B's fp64 copy is large
    (:func:`_by_columns`)."""
    with mock.patch.object(api, "matmul_tiled", _by_columns(matmul_tiled_plain)), \
            mock.patch.object(api, "matmul_mcast", _by_columns(matmul_mcast_plain)), \
            mock.patch.object(api, "matmul_unicast", _by_columns(matmul_unicast_plain)), \
            mock.patch.object(api, "paged_attention_decode", paged_attention_decode_plain), \
            mock.patch.object(api, "paged_attention_prefill", paged_attention_prefill_plain), \
            mock.patch.object(api, "flash_attention", flash_attention_plain), \
            mock.patch.object(api, "flash_attention_bwd_dq", flash_attention_bwd_dq_plain), \
            mock.patch.object(api, "flash_attention_bwd_dkv", flash_attention_bwd_dkv_plain), \
            mock.patch.object(api, "ssd_scan", ssd_scan_plain), \
            mock.patch.object(api, "ssd_scan_bwd", ssd_scan_bwd_plain), \
            mock.patch.object(api, "rglru_scan", rglru_scan_plain), \
            mock.patch.object(api, "rglru_scan_bwd", rglru_scan_bwd_plain):
        yield


def _bucketed(prompt):
    padded = torch.zeros((1, 48), dtype=torch.long, device="cuda")  # the 48-token bucket
    padded[0, :len(prompt)] = prompt
    return padded


def model_run(cfg, params, prompt, step_tokens, *, time_step=False):
    """One bucketed cold prefill scattered into pages, then one decode step
    for a batch of 4 against those pages; returns both logits (and, with
    ``time_step``, the decode step's device and host ms)."""
    pools = lm.init_paged_cache(cfg, 33, 16, device="cuda")
    n = len(prompt)  # 45 tokens: the 48-token bucket, as the engine pads it
    pre, dense = lm.prefill(params, cfg, _bucketed(prompt), logit_index=n - 1)
    lm.prefill_to_pages(dense, pools, torch.tensor([1, 2, 3], device="cuda",
                                                   dtype=torch.int32), n)
    # four sequences share the first two prompt pages; each gets its own
    # copy of the third, which its decode token writes into
    table = torch.zeros((4, 16), dtype=torch.int32, device="cuda")
    table[:, :2] = torch.tensor([1, 2], dtype=torch.int32)
    table[:, 2] = torch.arange(5, 9, dtype=torch.int32)
    for c in pools:
        for t in c:
            t[:, 5:9] = t[:, 3:4]
    index = torch.full((4,), n, dtype=torch.long, device="cuda")
    lengths = torch.full((4,), n + 1, dtype=torch.int32, device="cuda")
    def step():
        return lm.decode_step(params, cfg, pools, step_tokens, index, block_table=table,
                              lengths=lengths)[0]

    dec = step()
    if time_step:  # the step rewrites the same rows: repeating it is idempotent
        return pre, dec, step_stats(step)
    return pre, dec


def suffix_model_run(cfg, params, prefix, suffix):
    """The paged engine's prefix hit: the shared prefix's bucketed cold
    prefill scattered into pages, then the divergent suffix prefilled over
    those pages at its true positions in one ``decode_step`` call (K3),
    as the engine's suffix prefill runs it; returns the suffix's logits."""
    pools = lm.init_paged_cache(cfg, 33, 16, device="cuda")
    n, s = len(prefix), len(suffix)
    _, dense = lm.prefill(params, cfg, _bucketed(prefix), logit_index=n - 1)
    table = torch.zeros((1, 16), dtype=torch.int32, device="cuda")
    table[0, :-(-(n + s) // 16)] = torch.arange(1, -(-(n + s) // 16) + 1, dtype=torch.int32)
    lm.prefill_to_pages(dense, pools, table[0, :-(-n // 16)], n)
    del dense
    index = torch.tensor([n], dtype=torch.long, device="cuda")
    lengths = torch.tensor([n + s], dtype=torch.int32, device="cuda")
    return lm.decode_step(params, cfg, pools, suffix[None], index, block_table=table,
                          lengths=lengths)[0]


def dense_model_run(cfg, params, prompt, step_tokens, *, time_step=False):
    """The dense server's path: one bucketed prefill into 256-slot rings,
    masked past the prompt and copied to all 4 batch slots, then one
    decode step for the batch; returns both logits (and, with
    ``time_step``, the decode step's device and host ms)."""
    caches = lm.init_cache(cfg, 4, 256, device="cuda")
    n = len(prompt)
    pre, one = lm.prefill(params, cfg, _bucketed(prompt), cache_slots=256, logit_index=n - 1)
    for full, c in zip(caches, lm.mask_cache_after(one, n)):
        for dst, src in zip(full, c):
            dst[:] = src
    index = torch.full((4,), n, dtype=torch.long, device="cuda")

    def step():
        return lm.decode_step(params, cfg, caches, step_tokens, index)[0]

    dec = step()
    if time_step:  # the step rewrites the same ring rows: idempotent
        return pre, dec, step_stats(step)
    return pre, dec


def profile_step(step, top: int = 0) -> dict:
    """One step under ``torch.profiler``: the summed device time of its
    kernels and copies, how many there were, and the span from the first
    start to the last end (with ``top``, also the ``top`` device ops by
    summed ms, by name).  No spin kernel runs first, so the span includes
    the card's waits for the host.  A reading, not a check: if the
    profiler cannot trace the card, the record says why."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as exc:  # noqa: BLE001
        return dict(profile_error=repr(exc)[:300])
    if not evs:
        return dict(profile_error="the profiler recorded no device events")
    out = dict(device_ops=len(evs),
               device_op_sum_ms=sum(e.time_range.elapsed_us() for e in evs) / 1e3,
               device_span_ms=(max(e.time_range.end for e in evs)
                               - min(e.time_range.start for e in evs)) / 1e3)
    if top:
        by_name: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
        for e in evs:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
        out["top_device_ops"] = [dict(name=n[:120], count=c, ms=ms) for n, (c, ms) in
                                 sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]]
    return out


def step_stats(step, top: int = 0) -> dict:
    """A decode step's device ms (CUDA events behind a spin kernel) and
    host ms, the port's kernel launches in it, and its profile.  The
    events can also time the card waiting for the host — a step enqueues
    some 2,000 device ops, and the host may block on a full launch queue
    before the spin ends — so the busy share comes from the profile's
    summed device time, not from the events."""
    device_ms, host_ms = time_ms(step, runs=10, max_spin_s=1.0)
    kernels.reset_launch_counts()
    step()
    launches = sum(kernels.launch_counts().values())
    prof = profile_step(step, top)
    busy = prof.get("device_op_sum_ms")
    return dict(device_ms=device_ms, host_ms=host_ms,
                device_busy_share=None if busy is None else min(1.0, busy / host_ms),
                port_launches=launches, **prof)


def check_dispatch(resolves_per_step: int) -> None:
    """Host µs of one schedule resolution as ``linear`` makes it at a
    decode shape: memoised (what runs) and unmemoised (the cost model
    evaluated afresh), and what each adds to a decode step."""
    mm, pol = api.op("matmul"), kernels.get_policy()
    problem = api.Problem((4, 1024, 1024), "bfloat16")

    def us_per_call(fn, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    memo = us_per_call(lambda: mm.resolve(api.Problem((4, 1024, 1024), "bfloat16")), 20000)
    fresh = us_per_call(lambda: mm.pick(problem, pol), 2000)
    emit(dict(check="dispatch", shape=[4, 1024, 1024], resolve_us=memo,
              unmemoised_resolve_us=fresh, resolves_per_decode_step=resolves_per_step,
              resolve_ms_per_step=memo * resolves_per_step / 1e3,
              unmemoised_ms_per_step=fresh * resolves_per_step / 1e3))


def _compare_logits(tag: dict, pairs) -> None:
    torch.cuda.synchronize()
    for name, got, want in pairs:
        err = max_err(got, want)
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        emit(dict(check="model", name=name, **tag, shape=list(got.shape), max_err=err,
                  max_abs_logit=scale, tol=TOL_MODEL * scale, argmax_agree=agree))
        if not (torch.isfinite(got).all() and err <= TOL_MODEL * scale):
            raise AssertionError(f"full model {name} {tag}: kernels vs plain versions max abs "
                                 f"err {err} > {TOL_MODEL} x {scale}")


def check_model(cfg, params):
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    pre_k, dec_k, stats = model_run(cfg, params, prompt, step, time_step=True)
    emit(dict(check="decode_step_time", kv="paged", policy="default", batch=4,
              context=len(prompt) + 1, **stats))
    check_dispatch(stats["port_launches"])  # one resolution per launch
    with plain_versions():
        pre_p, dec_p = model_run(cfg, params, prompt, step)
    _compare_logits(dict(kv="paged", policy="default"),
                    (("prefill", pre_k, pre_p), ("decode_step", dec_k, dec_p)))
    for policy in POLICIES:  # a forced matmul schedule runs the dense path only
        with kernels.use_policy(policy):
            pre_k, dec_k, stats = dense_model_run(cfg, params, prompt, step, time_step=True)
            with plain_versions():
                pre_p, dec_p = dense_model_run(cfg, params, prompt, step)
        emit(dict(check="decode_step_time", kv="dense", policy=policy, batch=4,
                  context=len(prompt) + 1, **stats))
        _compare_logits(dict(kv="dense", policy=policy),
                        (("prefill", pre_k, pre_p), ("decode_step", dec_k, dec_p)))


def spec_model_run(cfg, params, prompt, verify_tokens, *, kv_dtype="int8", time_step=False):
    """The speculative path's target steps: one bucketed cold prefill
    scattered (quantised, on int8 pools) into pages, then for a batch of 4
    against those pages one plain decode step (``verify_tokens[:, :1]``)
    and one verify step (all ``k + 1`` tokens, ``s = 5``: K3 on int8
    pools); returns the three logits (and, with ``time_step``, both
    steps' stats)."""
    pools = lm.init_paged_cache(cfg, 33, 16, kv_dtype, device="cuda")
    n = len(prompt)  # 45 tokens: the 48-token bucket
    pre, dense = lm.prefill(params, cfg, _bucketed(prompt), logit_index=n - 1)
    lm.prefill_to_pages(dense, pools, torch.tensor([1, 2, 3], device="cuda",
                                                   dtype=torch.int32), n)
    # four sequences share the first two prompt pages; each gets its own
    # copy of the third (positions 32-47) and a fresh fourth (48-63),
    # which the verify burst (positions 45-49) reaches
    table = torch.zeros((4, 16), dtype=torch.int32, device="cuda")
    table[:, :2] = torch.tensor([1, 2], dtype=torch.int32)
    table[:, 2] = torch.arange(5, 9, dtype=torch.int32)
    table[:, 3] = torch.arange(9, 13, dtype=torch.int32)
    for c in pools:
        for t in c:  # K, V and, on int8 pools, their scales
            t[:, 5:9] = t[:, 3:4]
    index = torch.full((4,), n, dtype=torch.long, device="cuda")
    s = verify_tokens.shape[1]

    def decode():
        return lm.decode_step(params, cfg, pools, verify_tokens[:, :1], index,
                              block_table=table, lengths=index.int() + 1)[0]

    def verify():
        return lm.decode_step(params, cfg, pools, verify_tokens, index, block_table=table,
                              lengths=index.int() + s)[0]

    dec = decode()  # each step rewrites the same rows: repeating it is idempotent
    ver = verify()
    if time_step:
        return pre, dec, ver, step_stats(decode), step_stats(verify)
    return pre, dec, ver


def check_spec_model(cfg, params) -> None:
    """qwen1.5-1.8b at full width on int8 pools: the cold prefill, a plain
    decode step and a verify step at ``s = 5``, through the kernels and
    through the plain versions, each step timed, counted and profiled."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    toks = torch.randint(0, cfg.vocab, (4, 5), device="cuda", generator=gen)
    pre_k, dec_k, ver_k, dec_stats, ver_stats = spec_model_run(cfg, params, prompt, toks,
                                                               time_step=True)
    for step, stats, s in (("decode", dec_stats, 1), ("verify", ver_stats, 5)):
        emit(dict(check="decode_step_time", arch=cfg.name, kv="paged-int8", step=step,
                  policy="default", batch=4, tokens_per_row=s, context=len(prompt) + s,
                  **stats))
    with plain_versions():
        pre_p, dec_p, ver_p = spec_model_run(cfg, params, prompt, toks)
    _compare_logits(dict(arch=cfg.name, kv="paged-int8", policy="default"),
                    (("prefill", pre_k, pre_p), ("decode_step", dec_k, dec_p),
                     ("verify_step", ver_k, ver_p)))


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def serving_requests(cfg):
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, cfg.vocab, size=32)]
    return [Request(rid=i, prompt=prefix + [int(t) for t in rng.integers(
        0, cfg.vocab, size=int(rng.integers(8, 29)))], max_new=32) for i in range(8)]


def serve_path(name: str, server, reqs, path_kernels: tuple[str, ...], policy=None,
               compare=None, plan=None) -> dict:
    """Drive one main path: every launch count set to 0 just before,
    read just after.  Fails unless every request drained with its tokens
    and every kernel of ``path_kernels`` — and no other — was launched.
    ``compare``: (label, streams, margins) of a plain run to hold the
    streams to (:func:`compare_streams`).  ``plan``: a :class:`FaultPlan`
    armed around the run; then a request may instead fail with the
    engine's typed error."""
    first: dict[int, float] = {}
    admit = server._admit

    def timed_admit(req):
        res = admit(req)
        if res is True and req.rid not in first:
            first[req.rid] = time.perf_counter() - t0  # the sampler synced the card
        return res

    server._admit = timed_admit
    with kernels.use_policy(policy):  # None: the default policy
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plan or contextlib.nullcontext():
            done = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    n_tok = sum(len(r.out) for r in done)
    rec = dict(check="serving", path=name, policy=policy or "default", requests=len(done),
               new_tokens=n_tok, prompt_lens=[len(r.prompt) for r in reqs], wall_s=wall,
               tokens_per_s=n_tok / wall, ttft_median_s=statistics.median(first.values()),
               launches=launches)
    if isinstance(server, PagedEngine):
        server.check()
        stats = server.stats()
        rec.update(prefix_hit_tokens=stats["prefix_hit_tokens"],
                   kernel_calls=stats["kernel_calls"], accept_rate=stats["accept_rate"],
                   spec_rounds=stats["spec_rounds"],
                   spec_rollback_pages=stats["spec_rollback_pages"])
    failed = getattr(server, "failed", [])
    if plan is not None:
        rec.update(failed={r.rid: r.error for r in failed},
                   fired=[list(f) for f in plan.fired])
    if compare is not None:
        rec.update(compare_streams(done, *compare))
    emit(rec)
    if len(done) != len(reqs) or failed or any(len(r.out) != r.max_new for r in done):
        raise AssertionError(f"serving {name}: not every request drained with max_new tokens; "
                             f"failed: {[(r.rid, r.error) for r in failed]}")
    missing = [k for k in path_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"serving {name}: kernels never launched on the main path: "
                             f"{missing}")
    stray = [k for k, v in launches.items() if v and k not in path_kernels]
    if stray:
        raise AssertionError(f"serving {name}: kernels off this path were launched: {stray}")
    if compare is not None and rec["differing"] and rec["worst_margin_over_tol"] > 1:
        raise AssertionError(f"serving {name}: a stream differs from {compare[0]} where the "
                             f"plain run's top-two margin exceeds {TOL_MODEL} x max |logit|: "
                             f"{rec['differing']}")
    return launches


class MarginSampler(GreedySampler):
    """Greedy, and for each token it chooses the top-two logit margin and
    the largest |logit| of that row, keyed by (rid, token index): the
    engine's slots name the rows of a decode step, and the request being
    admitted the one row of an admission."""

    def __init__(self):
        self.engine = None
        self.admitting = None
        self.margins: dict[tuple[int, int], tuple[float, float]] = {}

    def attach(self, engine):
        self.engine = engine
        admit = engine._admit_impl

        def admit_impl(req):
            self.admitting = req
            try:
                return admit(req)
            finally:
                self.admitting = None

        engine._admit_impl = admit_impl
        return engine

    def rows(self) -> dict:
        """A decode step's rows: the engine's slots."""
        return {slot: st.req for slot, st in self.engine.slots.items()}

    def select(self, logits):
        out = super().select(logits)
        top2 = logits[:, -1].float().topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        scale = logits[:, -1].float().abs().amax(dim=-1).tolist()
        if self.admitting is not None:
            rows = {0: self.admitting}
        else:
            rows = self.rows()
        for row, req in rows.items():
            self.margins[(req.rid, len(req.out))] = (margin[row], scale[row])
        return out


class DenseMarginSampler(MarginSampler):
    """:class:`MarginSampler` for the dense ``Server``: an admission's row
    is the request admitted, a decode step's rows are the batch slots of
    ``server.active``."""

    def attach(self, server):
        self.engine = server
        admit = server._admit

        def admit_one(req):
            self.admitting = req
            try:
                return admit(req)
            finally:
                self.admitting = None

        server._admit = admit_one
        return server

    def rows(self) -> dict:
        return dict(self.engine.active)


def compare_streams(done, label, streams, margins) -> dict:
    """How many streams equal the plain run's, and for each that differs
    the plain run's top-two margin at the first differing token, over
    ``TOL_MODEL`` x that row's largest |logit| (<= 1: a near-tie)."""
    differing = []
    for r in done:
        want = streams[r.rid]
        if r.out == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(r.out, want)) if a != b)
        margin, scale = margins[(r.rid, j)]
        differing.append(dict(rid=r.rid, first_diff=j, margin=margin,
                              tol=TOL_MODEL * scale, over_tol=margin / (TOL_MODEL * scale)))
    return dict(compared_to=label, identical_streams=len(done) - len(differing),
                differing=differing,
                worst_margin_over_tol=max((d["over_tol"] for d in differing), default=0.0))


def near_tie_share(name: str, margins) -> dict:
    """The share of a plain run's tokens whose top-two margin is within
    ``TOL_MODEL`` x the row's largest |logit|: the tokens where
    :func:`compare_streams` would accept a difference."""
    under = sum(m <= TOL_MODEL * s for m, s in margins.values())
    return dict(check="near_tie_share", path=name, tokens=len(margins), near_ties=under,
                share=under / len(margins), tol_model=TOL_MODEL)


def matmul_path_kernels(cfg, rows) -> set[str]:
    """The matmul wrappers dispatch picks for ``cfg``'s projections and
    logits at each row count of ``rows`` (under the policy in force)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.attn.n_heads * cfg.attn.head_dim
    wrapper = {"tiled": "matmul_tiled", "mcast": "matmul_mcast", "unicast": "matmul_unicast"}
    picks = set()
    for m in rows:
        for k, n, dt in ((d, hd, torch.bfloat16), (hd, d, torch.bfloat16),
                         (d, f, torch.bfloat16), (f, d, torch.bfloat16),
                         (d, cfg.vocab, torch.float32)):
            picks.add(wrapper[kernels.resolve("matmul", (m, k, n), dt).schedule])
    return picks


def check_spec_serving(cfg, params, draft_model: str, dcfg, dparams) -> list[dict[str, int]]:
    """qwen1.5-1.8b at full width served over ``serving_requests``: on int8
    pools (a) plain decode, (b) speculative with its registered draft
    (``draft_for``, the qwen1.5-0.5b params of phase 3, same seed as the
    launcher's; ``draft_model`` names it), (c) speculative with the
    n-gram draft; on bf16 pools the
    plain run and (d) speculative with the draft, so that K2 serves the
    1.8b.  The speculative runs' streams are held to the plain run of
    their pools: equal, or differing first where the plain run's top-two
    margin is within ``TOL_MODEL`` of the row's largest |logit|."""
    k = 4
    # decode, verify, a prefill bucket; the draft's own rows are decode's
    mm_target = matmul_path_kernels(cfg, (4, 4 * (k + 1), 64))
    mm_draft = matmul_path_kernels(dcfg, (4, 64))
    runs, plain = [], {}
    for kv_dtype, draft_model, label in (
            ("int8", None, "paged-int8"),
            ("int8", draft_model, "paged-int8-spec-model"),
            ("int8", "ngram", "paged-int8-spec-ngram"),
            ("bf16", None, "paged-bf16"),
            ("bf16", draft_model, "paged-bf16-spec-model")):
        spec = dict(spec_k=k, draft_model=draft_model) if draft_model else {}
        sampler = MarginSampler() if draft_model is None else None
        draft = (dcfg, dparams) if draft_model not in (None, "ngram") else None
        eng = PagedEngine(cfg, params, config=ServeConfig(kv_dtype=kv_dtype, **spec),
                          sampler=sampler, draft=draft, device="cuda")
        if sampler is not None:
            sampler.attach(eng)
        # int8 pools run every attention call on K3; bf16 decode runs K2
        path = mm_target | {"paged_attention_prefill"}
        if kv_dtype == "bf16":
            path |= {"paged_attention_decode"}
        if draft is not None:
            path |= mm_draft
        reqs = serving_requests(cfg)
        runs.append(serve_path(f"{cfg.name} {label}", eng, reqs, tuple(sorted(path)),
                               compare=None if sampler is not None else plain[kv_dtype]))
        if sampler is not None:
            plain[kv_dtype] = (label, {r.rid: list(r.out) for r in reqs}, sampler.margins)
            emit(near_tie_share(f"{cfg.name} {label}", sampler.margins))
    return runs


def check_serving(cfg, params) -> dict[str, int]:
    """The paged engine under the default policy, then the dense server
    under the default policy, mcast and unicast; returns each kernel's
    launches summed over the runs."""
    paged = ("matmul_tiled", "paged_attention_decode", "paged_attention_prefill")
    runs = [serve_path("paged", PagedEngine(cfg, params, config=ServeConfig(), device="cuda"),
                       serving_requests(cfg), paged)]
    for policy, kernel in ((None, "matmul_tiled"), ("mcast", "matmul_mcast"),
                           ("unicast", "matmul_unicast")):
        runs.append(serve_path("dense", Server(cfg, params, device="cuda"),
                               serving_requests(cfg), (kernel,), policy))
    return {k: sum(r[k] for r in runs) for k in kernels.KERNELS}


# ---------------------------------------------------------------------------
# phase 5: the reference backend, degraded serving, the ServeLoop
# ---------------------------------------------------------------------------

#: calls of each family's reference schedule (:func:`count_reference_calls`)
REFERENCE_CALLS: collections.Counter = collections.Counter()


def count_reference_calls() -> None:
    """Re-register every family with its reference schedule counted in
    ``REFERENCE_CALLS``: the evidence that a phase resolved no serving
    call to the oracle, or ran it where it should."""
    def counted(family, fn):
        def call(*args, **kw):
            REFERENCE_CALLS[family] += 1
            return fn(*args, **kw)
        return call

    for op_ in list(api._REGISTRY.values()):
        api.register(dataclasses.replace(op_, schedules=tuple(
            dataclasses.replace(s, fn=counted(op_.name, s.fn)) if s.backend == "reference" else s
            for s in op_.schedules)))


def check_clean(phase: str) -> None:
    """A phase that injects no fault ends with no fallback counted and no
    reference schedule run; the counters restart for the next phase."""
    st = kernels.fallback_stats()
    emit(dict(check="no_fallback", phase=phase, guarded_calls=st.calls, fallbacks=st.fallbacks,
              reference_calls=dict(REFERENCE_CALLS)))
    if st.fallbacks or sum(REFERENCE_CALLS.values()):
        raise AssertionError(f"{phase}: {st.fallbacks} fallbacks, reference calls "
                             f"{dict(REFERENCE_CALLS)} in a phase that injects no fault")
    kernels.reset_fallback_stats()
    REFERENCE_CALLS.clear()


def check_reference(cfg, params) -> None:
    """Phase 5a: qwen1.5-0.5b at full width with every family on its
    reference schedule (``use_policy("reference")``): the prefill and one
    decode step for a batch of 4 held to the kernel path's logits
    (``TOL_MODEL``, argmax agreement reported, as phase 3 does), and the
    reference decode step timed beside the kernel step — what one retried
    step costs.  The reference step must launch no kernel."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    pre_k, dec_k, kstats = model_run(cfg, params, prompt, step, time_step=True)
    REFERENCE_CALLS.clear()
    with kernels.use_policy("reference"):
        pre_r, dec_r, rstats = model_run(cfg, params, prompt, step, time_step=True)
    ref_calls = dict(REFERENCE_CALLS)
    REFERENCE_CALLS.clear()
    emit(dict(check="reference_step_time", kv="paged", batch=4, context=len(prompt) + 1,
              reference_calls=ref_calls,
              **{f"kernel_{k}": v for k, v in kstats.items()},
              **{f"reference_{k}": v for k, v in rstats.items()},
              device_ms_ratio=rstats["device_ms"] / kstats["device_ms"],
              host_ms_ratio=rstats["host_ms"] / kstats["host_ms"]))
    if rstats["port_launches"] or not ref_calls.get("paged_attention") \
            or not ref_calls.get("matmul"):
        raise AssertionError(f"reference step: {rstats['port_launches']} kernel launches, "
                             f"reference calls {ref_calls}")
    _compare_logits(dict(kv="paged", policy="reference vs default"),
                    (("prefill", pre_r, pre_k), ("decode_step", dec_r, dec_k)))


#: the degraded-serving pool: 16 usable pages of 16 tokens for 4 slots of
#: requests that grow to 6 pages each, so decode page faults preempt
DEGRADED_PAGES = 17


def degraded_plan() -> FaultPlan:
    """One seeded plan with every fault kind of the serving stack at fixed
    hits: two kernel raises and a NaN output (retried on the reference
    backend), a corrupted page in the first cached prefix chain (caught by
    the next prefix hit), a lost swap blob (the request replays) and a
    forced pool exhaustion."""
    return FaultPlan([Fault("kernel.raise", at=6), Fault("kernel.raise", at=40),
                      Fault("kernel.nan", at=20), Fault("page.corrupt", at=0, page_index=0),
                      Fault("swap.drop", at=0), Fault("pool.alloc", at=3)], seed=0)


def check_degraded_serving(cfg, params) -> list[dict[str, int]]:
    """Phase 5b: qwen1.5-0.5b at full width on the paged engine over a pool
    small enough to preempt (``DEGRADED_PAGES``): (a) guards off, the
    streams and their top-two margins; (b) ``kv_guard`` and
    ``kernel_fallback`` armed, no plan — the streams must equal (a)'s and
    nothing may fall back; (c) the same engine under ``degraded_plan`` —
    every request drains (one corrupted page and one forced exhaustion
    requeue none past ``MAX_DEGRADE_REQUEUES``: a failed request fails
    the phase), the pool audit is green,
    fallbacks equal the kernel faults that fired, pages were
    quarantined, and the streams equal (a)'s but where (a)'s top-two
    margin is a near-tie (a retried step runs on reference numerics)."""
    path = ("matmul_tiled", "paged_attention_decode", "paged_attention_prefill")
    conf = dict(pages=DEGRADED_PAGES)
    sampler = MarginSampler()
    eng = sampler.attach(PagedEngine(cfg, params, config=ServeConfig(**conf), sampler=sampler,
                                     device="cuda"))
    reqs = serving_requests(cfg)
    runs = [serve_path("paged-small-pool", eng, reqs, path)]
    clean = {r.rid: list(r.out) for r in reqs}
    if not eng.n_preempted:
        raise AssertionError("degraded serving: the small pool preempted nothing")
    guarded = PagedEngine(cfg, params, device="cuda",
                          config=ServeConfig(kv_guard=True, kernel_fallback=True, **conf))
    reqs = serving_requests(cfg)
    runs.append(serve_path("paged-small-pool guarded", guarded, reqs, path))
    st = guarded.stats()
    if {r.rid: list(r.out) for r in reqs} != clean or st["kernel_fallbacks"] \
            or st["quarantined_pages"]:
        raise AssertionError(f"guards on, no plan: streams differ or it degraded: {st}")
    check_clean("guards on, no plan")

    eng = PagedEngine(cfg, params, device="cuda",
                      config=ServeConfig(kv_guard=True, kernel_fallback=True, **conf))
    plan = degraded_plan()
    runs.append(serve_path("paged-small-pool degraded", eng, serving_requests(cfg), path,
                           compare=("paged-small-pool", clean, sampler.margins), plan=plan))
    st, fb = eng.stats(), kernels.fallback_stats()
    fired = collections.Counter(site for site, _ in plan.fired)
    kernel_faults = fired["kernel.raise"] + fired["kernel.nan"]
    emit(dict(check="degraded_serving", fired=[list(f) for f in plan.fired],
              kernel_faults=kernel_faults, fallbacks=fb.fallbacks, raised=fb.raised,
              numeric_trips=fb.numeric_trips, guarded_calls=fb.calls,
              engine_fallbacks=st["kernel_fallbacks"], quarantined_pages=st["quarantined_pages"],
              swap_dropped=st["swap_dropped"], preempted=st["preempted"],
              degrade_requeues=st["degrade_requeues"], failed=st["failed"],
              rejected=st["rejected"], reference_calls=dict(REFERENCE_CALLS)))
    missing = {"kernel.raise", "kernel.nan", "page.corrupt", "swap.drop", "pool.alloc"} - set(fired)
    if missing:
        raise AssertionError(f"degraded serving: planned faults never fired: {missing}")
    if not (fb.fallbacks == st["kernel_fallbacks"] == kernel_faults > 0):
        raise AssertionError(f"degraded serving: {fb.fallbacks} fallbacks "
                             f"({st['kernel_fallbacks']} in stats) for {kernel_faults} kernel faults")
    if st["quarantined_pages"] <= 0 or st["swap_dropped"] <= 0:
        raise AssertionError(f"degraded serving: nothing quarantined or no swap lost: {st}")
    kernels.reset_fallback_stats()
    REFERENCE_CALLS.clear()
    return runs


def check_serve_loop(cfg, params) -> dict[str, int]:
    """Phase 5c: qwen1.5-0.5b at full width behind the async ``ServeLoop``
    (``max_slots`` 4): a seeded Poisson trace of 1.5 requests/s over 6 s,
    half opening with a 32-token shared prefix, 24-32 new tokens each,
    arriving in real time after ``warmup_for_trace``.  Every launch count
    is 0 just before the trace and read just after.  Fails unless every
    request drained, the mean batch occupancy is above 1, a prefill
    landed while others decoded, the snapshot validates against the
    schema, no kernel library was built or loaded during the trace, and
    the streams equal the synchronous ``PagedEngine.run`` replay of the
    same trace but where the replay's top-two margin is a near-tie."""
    trace = LoadGen(seed=0, qps=1.5, duration=6.0, vocab=cfg.vocab, prompt_len=(8, 28),
                    max_new=(24, 32), shared_prefix_len=32, shared_frac=0.5).trace()
    loop = ServeLoop(PagedEngine(cfg, params, config=ServeConfig(max_slots=4), device="cuda"))
    t0 = time.perf_counter()
    warm = loop.warmup_for_trace(trace)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    loaded = sorted(_build._LOADED)
    kernels.reset_launch_counts()
    results = loop.run_trace(trace, warmup=False)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    snap = validate_snapshot(loop.snapshot())
    loop.engine.check()
    sampler = MarginSampler()
    sync = sampler.attach(PagedEngine(cfg, params, config=ServeConfig(max_slots=4),
                                      sampler=sampler, device="cuda"))
    done = sync.run([Request(rid=a.rid, prompt=list(a.prompt), max_new=a.max_new)
                     for a in trace])
    cmp = compare_streams([r.engine_req for r in results.values()], "sync replay",
                          {r.rid: list(r.out) for r in done}, sampler.margins)
    states = collections.Counter(r.state.name for r in results.values())
    keys = ("requests_total", "tokens_out", "duration_s", "sustained_tok_s", "ttft_p50_ms",
            "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms", "queue_wait_p50_ms", "queue_wait_p99_ms",
            "decode_ticks", "occupancy_mean", "occupancy_max", "prefills",
            "prefills_mid_decode", "bucket_compiles", "kernel_fallbacks",
            "engine_prefix_hit_tokens", "engine_preempted")
    emit(dict(check="serve_loop", card=card_line(), qps=1.5, duration_s_trace=6.0,
              warmup_steps=warm, warmup_s=warm_s, states=dict(states),
              launches={k: v for k, v in launches.items() if v},
              libraries_loaded_during_trace=sorted(set(_build._LOADED) - set(loaded)),
              **{k: snap[k] for k in keys}, **cmp))
    path = ("matmul_tiled", "paged_attention_decode", "paged_attention_prefill")
    if set(states) != {"DRAINED"} or snap["occupancy_mean"] <= 1 \
            or snap["prefills_mid_decode"] < 1 or sorted(_build._LOADED) != loaded:
        raise AssertionError(f"serve loop: states {dict(states)}, occupancy "
                             f"{snap['occupancy_mean']}, prefills mid-decode "
                             f"{snap['prefills_mid_decode']}, libraries {sorted(_build._LOADED)}")
    if [k for k in path if not launches[k]] or [k for k, v in launches.items()
                                                 if v and k not in path]:
        raise AssertionError(f"serve loop: launches {launches}, path {path}")
    if cmp["differing"] and cmp["worst_margin_over_tol"] > 1:
        raise AssertionError(f"serve loop: a stream differs from the sync replay where its "
                             f"top-two margin exceeds {TOL_MODEL} x max |logit|: "
                             f"{cmp['differing']}")
    check_clean("serve loop")
    return launches


# ---------------------------------------------------------------------------
# phase 6: mixture-of-experts serving, moonshot-v1-16b-a3b at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b-a3b"
# grouped rows, (label, g, m, k, n, K1's activation): the 64 experts' gate
# (silu fused in K1) and up projections and the down projection at a
# decode step of 4 sequences (4 x top-6 = 24 rows an expert, every expert
# computed, empty slots too, as the reference dispatch does), and the gate
# at a 512-token prompt (capacity 60); the first is the kernels line's
GROUPED_ROWS = (("decode-gate", 64, 24, 2048, 1408, "silu"),
                ("decode-up", 64, 24, 2048, 1408, "none"),
                ("decode-down", 64, 24, 1408, 2048, "none"),
                ("prefill-gate", 64, 60, 2048, 1408, "silu"))


def check_grouped(gen, label, g, m, k, n, activation) -> dict[str, dict]:
    """K1 (with ``activation`` fused), K4 and K5 on one stack of ``g``
    expert products (A (g, m, k), B (g, k, n), bf16), one launch each:
    each against its plain version (per-group products) at ``TOL_BF16``,
    each timed beside the plain version, ``torch.bmm`` on the same
    operands and the byte / flop bound of the stack, with its design and
    K split."""
    from repro_torch.kernels.matmul import matmul as mm_mod

    a = torch.randn(g, m, k, device="cuda", generator=gen).to(torch.bfloat16)
    b = (torch.randn(g, k, n, device="cuda", generator=gen) / math.sqrt(k)).to(torch.bfloat16)
    b_ms, b_by = bound(2.0 * g * m * n * k, (a.numel() + b.numel() + g * m * n) * 2, PEAK_BF16)
    bmm_ms = time_ms(lambda: torch.bmm(a, b))[0]
    out = {}
    for fn, plain in ((matmul_tiled, lambda: matmul_tiled_plain(a, b, activation=activation)),
                      (matmul_mcast, lambda: matmul_mcast_plain(a, b)),
                      (matmul_unicast, lambda: matmul_unicast_plain(a, b))):
        name = fn.__name__
        run = (lambda: fn(a, b, activation=activation)) if fn is matmul_tiled \
            else (lambda: fn(a, b))
        before = fn.launches
        got = run()
        launched = fn.launches - before
        if launched != 1:
            raise AssertionError(f"{name} grouped {label}: {launched} launches for one call")
        design = expect_design(name, m, k, n, False)
        err = check_close(f"{name} grouped {label}", got, plain(), TOL_BF16)
        k_ms, k_host = time_ms(run)
        out[name] = dict(
            check="grouped_kernel", name=name, row=label, shape=[g, m, k, n],
            activation=activation if fn is matmul_tiled else "none", design=design,
            splits=mm_mod._splits(name, n, k, g), launches_per_call=launched,
            kernel_ms=k_ms, host_ms=k_host, plain_ms=time_ms(plain, runs=5)[0],
            library="torch.bmm (no epilogue)", library_ms=bmm_ms, bound_ms=b_ms,
            bound_by=b_by, max_err=err, tol=TOL_BF16)
        emit(out[name])
    return out


def moe_requests(cfg):
    """4 prompts of 16-64 tokens, 8-16 new tokens each, from one seed."""
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(0, cfg.vocab, size=n)],
                    max_new=new) for i, (n, new) in enumerate(((16, 16), (37, 8), (64, 12),
                                                               (23, 16)))]


class RoutingPin:
    """The experts each MoE call routes to, recorded in one run (in call
    order: ``nn.moe.top_k``'s picks) and replayed in another: the replay
    computes its own probabilities, gates, capacity and products, and
    counts, per call, the tokens whose own top-k set differs from the one
    replayed, with the largest gap between the k-th and the (k+1)-th
    probability among them (a near-tie when small).  A routing decision
    is discrete: where two experts nearly tie, the last bits of a
    reordered fp32 sum pick one or the other and the token's output jumps
    by a gate's share of two experts' difference."""

    def __init__(self):
        self.ids: list[torch.Tensor] = []
        self.tokens = self.flipped = 0
        self.worst_gap = 0.0

    @contextlib.contextmanager
    def record(self):
        real = moe_mod.top_k

        def record(probs, k):
            vals, ids = real(probs, k)
            self.ids.append(ids)
            return vals, ids

        with mock.patch.object(moe_mod, "top_k", record):
            yield self

    @contextlib.contextmanager
    def replay(self):
        calls = iter(self.ids)

        def replay(probs, k):
            want = next(calls)
            sorted_p, own = torch.sort(probs, dim=-1, descending=True, stable=True)
            diff = (own[..., :k].sort(dim=-1).values != want.sort(dim=-1).values).any(-1)
            self.tokens += diff.numel()
            self.flipped += int(diff.sum())
            if bool(diff.any()) and k < probs.shape[-1]:
                gap = (sorted_p[..., k - 1] - sorted_p[..., k])[diff]
                self.worst_gap = max(self.worst_gap, float(gap.max()))
            return probs.gather(-1, want), want

        with mock.patch.object(moe_mod, "top_k", replay):
            yield self
        if next(calls, None) is not None:
            raise AssertionError("routing replay: the plain run made fewer MoE calls")

    def summary(self) -> dict:
        return dict(routing_calls=len(self.ids), routed_tokens=self.tokens,
                    routing_flips=self.flipped, worst_flip_gap=self.worst_gap)


class LayerCheck:
    """Every layer of a kernel run held to the plain versions on the same
    inputs: while armed, each attention (prefill, bidirectional and
    decode, global or local-window, dense rings or page pools), cross
    attention (prefill and cached), RG-LRU and SSD block (prefill and
    decode step), dense MLP, MoE and logits head (``lm``'s and the
    encoder-decoder's) runs through the kernels as usual and then once
    more through the plain versions on the inputs the kernel run gave it
    (a decode attention on a copy of its cache or pool as it was before
    the step; an MoE with the kernel call's experts replayed), and each
    output is held to ``TOL_MODEL`` x its plain output's largest
    magnitude.  The kernel run goes on with its own outputs.

    This is how the full-depth MoE stack is checked: on seeded random
    weights its 47 MoE layers amplify a last-bit difference from layer to
    layer (the experts' weights take their fan-in from the expert axis,
    as in the JAX package, so each GLU expert has a gain far above 1),
    and a kernel run and a plain run of the same prompt end up sharing
    nothing (``model_unpinned``)."""

    KINDS = ("attention", "decode_attention", "paged_attention", "cross_attention",
             "cached_cross_attention", "mlp", "moe", "rglru", "rglru_step", "ssd", "ssd_step",
             "logits")

    def __init__(self):
        self.stats = {k: dict(calls=0, worst_ratio=0.0, max_err=0.0) for k in self.KINDS}
        self.routing = dict(routed_tokens=0, routing_flips=0, worst_flip_gap=0.0)
        self.argmax = []

    def _hold(self, kind, got, want):
        err = max_err(got, want)
        ratio = err / (TOL_MODEL * float(want.detach().abs().max()))
        st = self.stats[kind]
        st["calls"] += 1
        st["worst_ratio"] = max(st["worst_ratio"], ratio)
        st["max_err"] = max(st["max_err"], err)
        if not bool(torch.isfinite(got).all()):
            st["worst_ratio"] = math.inf

    @contextlib.contextmanager
    def armed(self):
        real = dict(attention=attn_mod.attention, decode=attn_mod.decode_attention,
                    paged=attn_mod.paged_decode_attention, cross=attn_mod.cross_attention,
                    cached_cross=encdec.cached_cross_attention, mlp=lm.mlp, moe=moe_mod.moe,
                    logits=lm._logits, dec_logits=encdec._dec_logits)
        recurrent = {(mod, name): getattr(mod, name) for mod, name in (
            (rglru_mod, "rglru"), (rglru_mod, "rglru_step"), (ssd_mod, "ssd"),
            (ssd_mod, "ssd_step"))}

        def mixer(kind, fn):
            def run(p, x, *args, **kw):  # pure: the plain rerun takes the same state
                out, state = fn(p, x, *args, **kw)
                with plain_versions():
                    want, _ = fn(p, x, *args, **kw)
                self._hold(kind, out, want)
                return out, state
            return run

        def attention(p, x, cfg, **kw):
            out, kv = real["attention"](p, x, cfg, **kw)
            with plain_versions():
                want, _ = real["attention"](p, x, cfg, **kw)
            self._hold("attention", out, want)
            return out, kv

        def cached(kind, key):
            def run(p, x, cache, cfg, **kw):  # the plain rerun on the cache as it was
                before = type(cache)(*(t.clone() for t in cache))
                out, c = real[key](p, x, cache, cfg, **kw)
                with plain_versions():
                    want, _ = real[key](p, x, before, cfg, **kw)
                self._hold(kind, out, want)
                return out, c
            return run

        def cross(p, x, memory, cfg):
            out, kv = real["cross"](p, x, memory, cfg)
            with plain_versions():
                want, _ = real["cross"](p, x, memory, cfg)
            self._hold("cross_attention", out, want)
            return out, kv

        def cached_cross(p, x, cross_kv, cfg):
            out = real["cached_cross"](p, x, cross_kv, cfg)
            with plain_versions():
                want = real["cached_cross"](p, x, cross_kv, cfg)
            self._hold("cached_cross_attention", out, want)
            return out

        def mlp(p, x, cfg):
            out = real["mlp"](p, x, cfg)
            with plain_versions():
                want = real["mlp"](p, x, cfg)
            self._hold("mlp", out, want)
            return out

        def moe(p, x, cfg, **kw):
            pin = RoutingPin()
            with pin.record():
                out, aux = real["moe"](p, x, cfg, **kw)
            with plain_versions(), pin.replay():
                want, _ = real["moe"](p, x, cfg, **kw)
            self.routing["routed_tokens"] += pin.tokens
            self.routing["routing_flips"] += pin.flipped
            self.routing["worst_flip_gap"] = max(self.routing["worst_flip_gap"], pin.worst_gap)
            self._hold("moe", out, want)
            return out, aux

        def head(key):
            def logits(params, cfg, x):
                out = real[key](params, cfg, x)
                with plain_versions():
                    want = real[key](params, cfg, x)
                self._hold("logits", out, want)
                self.argmax.append(float((out.argmax(-1) == want.argmax(-1)).float().mean()))
                return out
            return logits

        with contextlib.ExitStack() as stack:
            for (mod, name), fn in recurrent.items():
                stack.enter_context(mock.patch.object(mod, name, mixer(name, fn)))
            with mock.patch.object(attn_mod, "attention", attention), \
                    mock.patch.object(attn_mod, "decode_attention",
                                      cached("decode_attention", "decode")), \
                    mock.patch.object(attn_mod, "paged_decode_attention",
                                      cached("paged_attention", "paged")), \
                    mock.patch.object(attn_mod, "cross_attention", cross), \
                    mock.patch.object(encdec, "cached_cross_attention", cached_cross), \
                    mock.patch.object(lm, "mlp", mlp), mock.patch.object(moe_mod, "moe", moe), \
                    mock.patch.object(lm, "_logits", head("logits")), \
                    mock.patch.object(encdec, "_dec_logits", head("dec_logits")):
                yield self

    def worst(self) -> float:
        return max(st["worst_ratio"] for st in self.stats.values())

    def summary(self) -> dict:
        return dict(layers=self.stats, logits_argmax_agree=self.argmax, tol_model=TOL_MODEL,
                    **self.routing)


def hold_layers(tag: dict, check: LayerCheck, logits_calls: int) -> None:
    """Emit a :class:`LayerCheck`'s record; fail unless every layer held
    ``TOL_MODEL`` and the logits head ran ``logits_calls`` times."""
    emit(dict(check="model_layers", **tag, worst_ratio=check.worst(), **check.summary()))
    if check.worst() > 1 or check.stats["logits"]["calls"] != logits_calls:
        raise AssertionError(f"full model {tag}: a layer's kernel output is off its plain "
                             f"version by {check.worst():.3g} x TOL_MODEL x max |plain|: "
                             f"{check.stats}")


def dense_server_model_run(cfg, params, prompt, step_tokens):
    """The dense server's path for MoE and the recurrent archs: one prefill
    at the prompt's own length (no bucket: padding would take expert
    capacity, or enter a ring or a recurrent state) into 256-slot rings
    (a local window's: min(window, 256)) and recurrent states, copied to
    all 4 batch slots, then one decode step for the batch; returns both
    logits and the step (rerunning it rewrites the same ring rows and
    replaces, not updates, the states: idempotent)."""
    caches = lm.init_cache(cfg, 4, 256, device="cuda")
    n = len(prompt)
    pre, one = lm.prefill(params, cfg, prompt[None], cache_slots=256, logit_index=n - 1)
    for full, c in zip(caches, one):
        for dst, src in zip(full, c):
            dst[:] = src
    del one
    index = torch.full((4,), n, dtype=torch.long, device="cuda")

    def step():
        return lm.decode_step(params, cfg, caches, step_tokens, index)[0]

    return pre, step(), step


def check_moe_model(cfg, params) -> None:
    """moonshot-v1-16b-a3b at full width and depth: one 45-token prefill and
    one decode step for a batch of 4 under the default policy, ``mcast``
    and ``unicast``, every layer and the logits held to the plain versions
    on the kernel run's own inputs (:class:`LayerCheck`, ``TOL_MODEL``;
    argmax agreement of the logits reported, routing flips counted).
    Under the default policy also the whole plain run on its own, held to
    nothing and reported (``model_unpinned``).  Each kernel decode step is
    timed, counted by kernel and profiled, beside the bytes every weight of
    the model takes to read once (a decode step computes every expert) and
    those of the routed experts alone."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step_tokens = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    experts = sum(lyr["moe"][w].numel() * 2 for lyr in params["layers"] if "moe" in lyr
                  for w in ("w_in", "w_gate", "w_out"))
    for policy in (None, "mcast", "unicast"):
        tag = dict(arch=cfg.name, kv="dense", policy=policy or "default")
        check = LayerCheck()
        with kernels.use_policy(policy):
            with check.armed():
                pre_k, dec_k, step = dense_server_model_run(cfg, params, prompt, step_tokens)
            stats = step_stats(step, top=8)
            kernels.reset_launch_counts()
            step()
            stats["launches_by_kernel"] = {k: v for k, v in kernels.launch_counts().items() if v}
            del step
            if policy is None:
                with plain_versions():
                    pre_u, dec_u, _ = dense_server_model_run(cfg, params, prompt, step_tokens)
                for name, got, want in (("prefill", pre_k, pre_u), ("decode_step", dec_k, dec_u)):
                    emit(dict(check="model_unpinned", name=name, **tag, max_err=max_err(got, want),
                              max_abs_logit=float(want.abs().max()),
                              argmax_agree=float((got.argmax(-1) == want.argmax(-1))
                                                 .float().mean())))
                del pre_u, dec_u
        emit(dict(check="decode_step_time", **tag, batch=4, context=len(prompt) + 1,
                  weight_bytes=weight_bytes, weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
                  routed_expert_bytes=experts,
                  routed_expert_bound_ms=experts / HBM_BYTES_PER_S * 1e3, **stats))
        hold_layers(tag, check, 2)
        del pre_k, dec_k


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


#: the stream comparison's depth: the dense first layer and 3 MoE layers
#: of the full-width model (its first 4 layers' weights).  At full depth
#: the random-weight stack turns a last-bit difference into a different
#: stream (:class:`LayerCheck`), so kernel and plain streams are compared
#: here, where a difference can only come from a near-tie.
MOE_STREAM_DEPTH = 4


def check_moe_serving(cfg, params) -> dict[str, int]:
    """The dense ``Server`` over :func:`moe_requests` under the default
    policy, ``mcast`` and ``unicast``.  At full depth each run is the main
    path: every request drained, its policy's matmul kernel and no other
    launched, tokens/s and TTFT.  Then, on the model's first
    ``MOE_STREAM_DEPTH`` layers at full width, the same requests through
    the kernels and through the plain versions with the kernel run's
    routing replayed (:class:`RoutingPin`), greedy with its top-two
    margins: the kernel streams must equal the plain run's but at
    near-ties (:func:`compare_streams`).  Returns each kernel's launches
    summed over the full-depth runs."""
    runs = []
    cut = dataclasses.replace(cfg, n_layers=MOE_STREAM_DEPTH, stages=(
        cfg.stages[0], (cfg.stages[1][0], MOE_STREAM_DEPTH - 1)))
    params_cut = dict(params, layers=params["layers"][:MOE_STREAM_DEPTH])
    for policy, kernel in ((None, "matmul_tiled"), ("mcast", "matmul_mcast"),
                           ("unicast", "matmul_unicast")):
        runs.append(serve_path(f"{cfg.name} dense", Server(cfg, params, device="cuda"),
                               moe_requests(cfg), (kernel,), policy))
        label = f"{cfg.name} dense {policy or 'default'} first {MOE_STREAM_DEPTH} layers"
        pin, done = RoutingPin(), moe_requests(cfg)
        with pin.record(), kernels.use_policy(policy):
            Server(cut, params_cut, device="cuda").run(done)
        sampler, reqs = DenseMarginSampler(), moe_requests(cfg)
        with plain_versions(), pin.replay(), kernels.use_policy(policy):
            sampler.attach(Server(cut, params_cut, sampler=sampler, device="cuda")).run(reqs)
        emit(near_tie_share(f"{label} plain", sampler.margins))
        cmp = compare_streams(done, "plain versions, routing replayed",
                              {r.rid: list(r.out) for r in reqs}, sampler.margins)
        emit(dict(check="serving_streams", path=label, depth=MOE_STREAM_DEPTH, **cmp,
                  **pin.summary()))
        if cmp["differing"] and cmp["worst_margin_over_tol"] > 1:
            raise AssertionError(f"serving {label}: a stream differs from the plain run where "
                                 f"its top-two margin exceeds {TOL_MODEL} x max |logit|: "
                                 f"{cmp['differing']}")
    return {k: sum(r[k] for r in runs) for k in kernels.KERNELS}


# ---------------------------------------------------------------------------
# phase 7: recurrent serving, mamba2-780m (SSD) and recurrentgemma-2b (RG-LRU
# and local-window rings) at full width and full depth
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("mamba2-780m", "recurrentgemma-2b")
# the recurrent models' projections, (label, k, n, linear keywords): mamba2's
# in_proj and out_proj and tied logits; recurrentgemma's gate branch (gelu)
# and x branch (also the q and o projections' shape), the RG-LRU gates (bias,
# sigmoid, fp32 out), the MQA k / v (one 256-wide head), the GLU's gate
# (gelu_tanh; the up projection is the bare shape) and down projections, and
# its tied logits (fp32 x the bf16 table read transposed); the first is the
# first row of the phase's records
RECURRENT_ROWS = (
    ("mamba2-in", 1536, 6448, {}),
    ("mamba2-out", 3072, 1536, {}),
    ("mamba2-logits", 1536, 50280, dict(logits=True)),
    ("rg-gate-branch", 2560, 2560, dict(activation="gelu")),
    ("rg-x-branch", 2560, 2560, {}),
    ("rg-lru-gate", 2560, 2560, dict(bias=True, activation="sigmoid", out_dtype=torch.float32)),
    ("rg-kv", 2560, 256, {}),
    ("rg-mlp-gate", 2560, 7680, dict(activation="gelu_tanh")),
    ("rg-mlp-down", 7680, 2560, {}),
    ("rg-logits", 2560, 256000, dict(logits=True)),
)
RECURRENT_M = (4, 45)  # a decode step of 4 sequences, a 45-token prefill
POLICY_KERNELS = (("tiled", "matmul_tiled"), ("mcast", "matmul_mcast"),
                  ("unicast", "matmul_unicast"))
LONG_PROMPT = 4096


def check_projection_row(gen, label, m, k, n, kw, check="recurrent_matmul",
                         tc_sum=False) -> dict[str, dict]:
    """``kernels.linear`` at one projection of a model (phase 7's recurrent
    archs, ``check="recurrent_matmul"``; phase 8's families) under
    ``tiled``, ``mcast`` and ``unicast``: one launch of the policy's kernel
    on its tensor-core design, held to the same call on the plain versions
    (K4 and K5 run bias and activation after the product, as in the JAX
    package) at the tolerance of the dtype the result passes through (a
    bf16 product's fp32 sigmoid is a bf16 result), timed (the call,
    epilogue included) beside the plain version,
    ``torch.addmm`` / ``torch.matmul`` on the same operands and the bound of
    the product with its epilogue.  With ``tc_sum``, fp32 results may also
    move by :func:`tc_sum_allowance` (phase 8's rows, at k up to 8,192)."""
    kw = dict(kw)
    logits = kw.pop("logits", False)
    a, b, bias = matmul_operands(gen, m, k, n, logits=logits, bias=kw.pop("bias", False))
    out_dtype = kw.get("out_dtype") or a.dtype
    b_ms, b_by = matmul_bound(a, b, bias, out_dtype)
    library, lib_ms = matmul_library(a, b, bias, kw.get("activation", "none"))
    with plain_versions():
        plain_ms = time_ms(lambda: kernels.linear(a, b, bias=bias, policy="tiled", **kw),
                           runs=5)[0]
    out = {}
    for policy, kname in POLICY_KERNELS:
        def call():
            return kernels.linear(a, b, bias=bias, policy=policy, **kw)

        # the tolerance of the dtype the result passes through: K1 rounds
        # once, to out_dtype; K4 and K5 round the product to a's dtype first
        tol = TOL_FP32 if (out_dtype if policy == "tiled" else a.dtype) == torch.float32 \
            else TOL_BF16

        kernels.reset_launch_counts()
        got = call()
        counts = kernels.launch_counts()
        if counts[kname] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"{label} {m}x{k}x{n} {policy}: launches {counts}")
        design = expect_design(kname, m, k, n, logits)
        with plain_versions():
            want = call()
        if got.dtype != out_dtype or want.dtype != out_dtype:
            raise AssertionError(f"{label} {policy}: out dtype {got.dtype}, want {out_dtype}")
        extra = tc_sum_allowance(want, k) if tc_sum and got.dtype == torch.float32 else None
        err = check_close(f"{kname} {label} {m}x{k}x{n}", got, want, tol, extra)
        k_ms, k_host = time_ms(call)
        out[kname] = dict(
            check=check, name=kname, row=label, policy=policy, shape=[m, k, n],
            a_dtype=str(a.dtype), out_dtype=str(out_dtype), bias=bias is not None,
            activation=kw.get("activation", "none"), design=design, kernel_ms=k_ms,
            host_ms=k_host, plain_ms=plain_ms, library=library, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, max_err=err, tol=tol)
        emit(out[kname])
    return out


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def check_dense_model(cfg, params, policies=(None, "mcast", "unicast")) -> float:
    """One 45-token prefill and one decode step for a batch of 4 (the dense
    server's path, :func:`dense_server_model_run`) under the default policy,
    ``mcast`` and ``unicast`` (or ``policies``): every layer's mixer
    (global or local-window attention, RG-LRU or SSD, prefill and decode
    step), MLP and the logits
    held to the plain versions on the kernel run's own inputs
    (:class:`LayerCheck`, ``TOL_MODEL``), and the whole run's logits to a
    whole plain run (``model_whole``, reported: no MoE amplifies a last-bit
    difference here, so they are predicted to agree).  Each decode step
    timed, profiled and its launches counted by kernel, beside the bound of
    reading every weight once.  Returns the whole runs' worst gap over
    ``TOL_MODEL`` x max |plain logit|."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step_tokens = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    wbytes = weight_bytes(params)
    whole = 0.0
    for policy in policies:
        tag = dict(arch=cfg.name, kv="dense", policy=policy or "default")
        check = LayerCheck()
        with kernels.use_policy(policy):
            with check.armed():
                pre_k, dec_k, step = dense_server_model_run(cfg, params, prompt, step_tokens)
            stats = step_stats(step, top=8)
            kernels.reset_launch_counts()
            step()
            stats["launches_by_kernel"] = {k: v for k, v in kernels.launch_counts().items() if v}
            del step
            with plain_versions():
                pre_p, dec_p, _ = dense_server_model_run(cfg, params, prompt, step_tokens)
        torch.cuda.synchronize()
        for name, got, want in (("prefill", pre_k, pre_p), ("decode_step", dec_k, dec_p)):
            err, scale = max_err(got, want), float(want.abs().max())
            whole = max(whole, err / (TOL_MODEL * scale))
            emit(dict(check="model_whole", name=name, **tag, max_err=err, max_abs_logit=scale,
                      tol=TOL_MODEL * scale, within_tol=err <= TOL_MODEL * scale,
                      argmax_agree=float((got.argmax(-1) == want.argmax(-1)).float().mean())))
        emit(dict(check="decode_step_time", **tag, batch=4, context=len(prompt) + 1,
                  weight_bytes=wbytes, weight_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3, **stats))
        hold_layers(tag, check, 2)
        del pre_k, dec_k, pre_p, dec_p
    return whole


#: the whole-run comparison's second witness, at the model's depth over each
GAP_DEPTH_SHARES = (8, 4, 2, 1)


def cut_depth(cfg, params, n: int):
    """``cfg`` and ``params`` cut to their first ``n`` layers (the stages
    truncated in order; the embedding, final norm and head kept)."""
    stages, left = [], n
    for pattern, repeats in cfg.stages:
        take = min(repeats, left // len(pattern))
        if take:
            stages.append((pattern, take))
        left -= take * len(pattern)
        if take < repeats:
            if left:
                stages.append((pattern[:left], 1))
            break
    return (dataclasses.replace(cfg, n_layers=n, stages=tuple(stages)),
            dict(params, layers=params["layers"][:n]))


def check_depth_gap(cfg, params) -> None:
    """The second witness of the whole-run comparison (``model_whole``):
    the model cut to each depth ``n_layers // d`` (``GAP_DEPTH_SHARES``)
    runs :func:`dense_server_model_run`'s prefill and decode step (the
    same prompt, default policy) through the kernels, through the plain
    versions, and through the plain versions with the last bit of every
    element of the prefill's layer-0 input flipped (one bf16 ulp, the
    size of a kernel's rounding difference in one layer).  Each run's gap
    to the plain run is reported over ``TOL_MODEL`` x max |plain logit|
    (``depth_gap``): a stack that amplifies rounding moves both gaps up
    together with depth, where a kernel fault would part them."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step_tokens = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    real_embed, calls = lm._embed_inputs, []

    def flipped(*args):
        x = real_embed(*args)
        if not calls:  # the prefill's, not the decode step's
            assert x.dtype == torch.bfloat16
            x = (x.view(torch.int16) ^ 1).view(torch.bfloat16)
        calls.append(x.shape)
        return x

    for share in GAP_DEPTH_SHARES:
        c, p = cut_depth(cfg, params, cfg.n_layers // share)
        kern = dense_server_model_run(c, p, prompt, step_tokens)[:2]
        with plain_versions():
            plain = dense_server_model_run(c, p, prompt, step_tokens)[:2]
            calls.clear()
            with mock.patch.object(lm, "_embed_inputs", flipped):
                flip = dense_server_model_run(c, p, prompt, step_tokens)[:2]
        for i, name in enumerate(("prefill", "decode_step")):
            scale = float(plain[i].abs().max())
            emit(dict(check="depth_gap", arch=cfg.name, name=name, policy="default",
                      depth=c.n_layers, max_abs_logit=scale, tol_model=TOL_MODEL,
                      kernels_over_tol=max_err(kern[i], plain[i]) / (TOL_MODEL * scale),
                      flipped_bit_over_tol=max_err(flip[i], plain[i]) / (TOL_MODEL * scale),
                      kernels_argmax_agree=float((kern[i].argmax(-1) == plain[i].argmax(-1))
                                                 .float().mean()),
                      flipped_bit_argmax_agree=float((flip[i].argmax(-1) == plain[i]
                                                      .argmax(-1)).float().mean())))
        del kern, plain, flip


def check_long_prefill(cfg, params) -> None:
    """One ``LONG_PROMPT``-token prefill, batch 1, under the default policy,
    only the last row's logits computed (``logit_index``), then 4 decode
    steps on its caches: timed unchecked first, then every layer held to
    the plain versions (:class:`LayerCheck`).  recurrentgemma's local
    layers must take the banded path and leave rings of min(window,
    max(256, s)) slots shorter than the prompt (``_kv_from_full``'s ring
    layout: the last positions, each at ``position % slots``); mamba2's
    SSD layers walk s / chunk chunks."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    s = LONG_PROMPT
    prompt = torch.randint(0, cfg.vocab, (1, s), device="cuda", generator=gen)
    steps = torch.randint(0, cfg.vocab, (1, 4), device="cuda", generator=gen)

    def run():
        logits, caches = lm.prefill(params, cfg, prompt, cache_slots=256, logit_index=s - 1)
        dec = []
        for i in range(4):
            lo, caches = lm.decode_step(params, cfg, caches, steps[:, i:i + 1], s + i)
            dec.append(lo)
        return logits, caches, dec

    run()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    lm.prefill(params, cfg, prompt, cache_slots=256, logit_index=s - 1)
    end.record()
    end.synchronize()
    wall_ms, device_ms = (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)
    check, bands = LayerCheck(), []
    real_banded = memeff_mod._banded

    def banded(*a, **kw):
        bands.append(kw["band"])
        return real_banded(*a, **kw)

    with check.armed(), mock.patch.object(memeff_mod, "_banded", banded):
        logits, caches, dec = run()
    torch.cuda.synchronize()
    rings = {}
    for bd, c in zip(cfg.layer_defs, caches):
        if bd.mixer != "attn":
            continue
        slots = lm._slots(bd, max(256, s))
        kept = sorted(int(p) for p in c.pos[0].tolist())
        want = list(range(s + 4 - slots, s + 4))  # the prompt's last positions, then 4 decoded
        if c.k.shape[1] != slots or kept != want:
            raise AssertionError(f"{cfg.name} {s}-token prefill: ring of {c.k.shape[1]} slots "
                                 f"holding {kept[:3]}..{kept[-3:]}, want {slots} slots "
                                 f"holding {want[0]}..{want[-1]}")
        rings[bd.window] = slots
    n_attn = sum(bd.mixer == "attn" for bd in cfg.layer_defs)
    if len(bands) != 2 * n_attn:  # each local layer's kernel run and its plain rerun
        raise AssertionError(f"{cfg.name}: {len(bands)} banded calls for {n_attn} local layers "
                             f"run twice")
    chunks = -(-s // cfg.ssm.chunk) if cfg.ssm is not None else None
    rec = dict(check="long_prefill", arch=cfg.name, prompt=s, batch=1, policy="default",
               prefill_device_ms=device_ms, prefill_wall_ms=wall_ms, banded_calls=len(bands),
               band=sorted(set(bands)), ring_slots=rings, ssd_chunks=chunks,
               decode_steps=len(dec), finite=bool(torch.isfinite(logits).all()) and all(
                   bool(torch.isfinite(d).all()) for d in dec),
               worst_ratio=check.worst(), **check.summary())
    emit(rec)
    if not rec["finite"] or check.worst() > 1 or check.stats["logits"]["calls"] != 5:
        raise AssertionError(f"{cfg.name} {s}-token prefill: a layer is off its plain version "
                             f"by {check.worst():.3g} x TOL_MODEL, or not finite: {check.stats}")


def check_dense_serving(cfg, params) -> dict[str, int]:
    """The dense ``Server`` over :func:`moe_requests` (4 prompts of 16-64
    tokens, 8-16 new tokens) at full depth under the default policy,
    ``mcast`` and ``unicast``: every request drained, its policy's matmul
    kernel and no other launched, tokens/s and TTFT; then the same requests
    through the plain versions, greedy with its top-two margins: each
    kernel stream must equal the plain run's but at near-ties
    (:func:`compare_streams`).  Returns each kernel's launches summed over
    the kernel runs."""
    runs = []
    for policy, kernel in ((None, "matmul_tiled"), ("mcast", "matmul_mcast"),
                           ("unicast", "matmul_unicast")):
        sampler, reqs = DenseMarginSampler(), moe_requests(cfg)
        with plain_versions(), kernels.use_policy(policy):
            sampler.attach(Server(cfg, params, sampler=sampler, device="cuda")).run(reqs)
        label = f"{cfg.name} dense {policy or 'default'} plain"
        emit(near_tie_share(label, sampler.margins))
        runs.append(serve_path(f"{cfg.name} dense", Server(cfg, params, device="cuda"),
                               moe_requests(cfg), (kernel,), policy,
                               compare=(label, {r.rid: list(r.out) for r in reqs},
                                        sampler.margins)))
    return {k: sum(r[k] for r in runs) for k in kernels.KERNELS}


def check_recurrent(gen) -> tuple[dict[str, int], list]:
    """Phase 7: the new projections' rows, then per arch at full width and
    full depth (built on the card from the seed): :func:`check_dense_model`,
    :func:`check_depth_gap`, :func:`check_long_prefill`,
    :func:`check_dense_serving`.  Returns the serving launches and the
    rows' records."""
    rows = [check_projection_row(gen, label, m, k, n, kw)
            for label, k, n, kw in RECURRENT_ROWS for m in RECURRENT_M]
    launches = dict.fromkeys(kernels.KERNELS, 0)
    for arch in RECURRENT_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = lm.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        emit(dict(check="recurrent_model", arch=cfg.name, layers=cfg.n_layers, depth_cut="none",
                  params=sum(t.numel() for t in _leaves(params)), bytes=weight_bytes(params),
                  init_s=time.perf_counter() - t0,
                  memory_allocated_gb=torch.cuda.memory_allocated() / 1e9))
        check_dense_model(cfg, params)
        check_depth_gap(cfg, params)
        check_long_prefill(cfg, params)
        run = check_dense_serving(cfg, params)
        launches = {k: launches[k] + run[k] for k in kernels.KERNELS}
        del params
        torch.cuda.empty_cache()
    return launches, rows


# ---------------------------------------------------------------------------
# phase 8: the last model families at full width — whisper-medium through
# the encoder-decoder, pixtral-12b over patch embeddings, gemma2-9b on the
# dense Server, deepseek-7b, command-r-35b on the paged engine
# ---------------------------------------------------------------------------

# the new projections, (label, k, n, linear keywords): gemma2-9b's q (16
# heads of 256), k / v (8 of 256), o, GLU gate (gelu_tanh; up is the bare
# shape) and down, tied logits; command-r-35b's q / o, k / v (8 heads of
# 128), GLU gate (silu) and down, tied logits; pixtral-12b's front end and
# untied head (the bf16 (d, vocab) w read row-major); whisper-medium's MLP
# in (gelu) and tied logits (an odd N)
FAMILY_ROWS = (
    ("g2-q", 3584, 4096, {}),
    ("g2-kv", 3584, 2048, {}),
    ("g2-o", 4096, 3584, {}),
    ("g2-mlp-gate", 3584, 14336, dict(activation="gelu_tanh")),
    ("g2-mlp-down", 14336, 3584, {}),
    ("g2-logits", 3584, 256000, dict(logits=True)),
    ("cr-q-o", 8192, 8192, {}),
    ("cr-kv", 8192, 1024, {}),
    ("cr-mlp-gate", 8192, 22528, dict(activation="silu")),
    ("cr-mlp-down", 22528, 8192, {}),
    ("cr-logits", 8192, 256000, dict(logits=True)),
    ("px-frontend", 1024, 5120, {}),
    ("px-logits", 5120, 131072, dict(logits="untied")),
    ("wh-mlp-in", 1024, 4096, dict(activation="gelu")),
    ("wh-logits", 1024, 51865, dict(logits=True)),
)
FAMILY_M = (4, 45)  # a decode step of 4 sequences, a 45-token prefill
# (label, m, k, n, keywords): whisper's encoder input (two clips of 1,500
# frames, bf16 out) and pixtral's front end over two images' 256 patches
FAMILY_WIDE_ROWS = (("wh-encoder-in", 3000, 1024, 1024, dict(out_dtype=torch.bfloat16)),
                    ("px-frontend-patches", 512, 1024, 5120, {}))
WHISPER = "whisper-medium"
ENCDEC_NEW = 16  # decode steps after the prefill's token


def free_model() -> None:
    """Return a freed model's memory to the card before the next is built
    (closures over its tensors can sit in reference cycles)."""
    gc.collect()
    torch.cuda.empty_cache()


def build_model(module, cfg, label: str):
    """``module.init`` at full width on the card from seed 0, with its size
    and build time recorded."""
    t0 = time.perf_counter()
    params = module.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(dict(check=label, arch=cfg.name, layers=cfg.n_layers, depth_cut="none",
              params=sum(t.numel() for t in _leaves(params)), bytes=weight_bytes(params),
              init_s=time.perf_counter() - t0,
              memory_allocated_gb=torch.cuda.memory_allocated() / 1e9))
    return params


def hold_whole(tag: dict, pairs) -> float:
    """Each (name, kernel output, plain output) of a whole run, reported
    over ``TOL_MODEL`` x max |plain| with its argmax agreement (not gated:
    every layer is, by :class:`LayerCheck`); returns the worst ratio."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, got, want in pairs:
        err, scale = max_err(got, want), float(want.abs().max())
        worst = max(worst, err / (TOL_MODEL * scale))
        emit(dict(check="model_whole", name=name, **tag, max_err=err, max_abs=scale,
                  tol=TOL_MODEL * scale, within_tol=err <= TOL_MODEL * scale,
                  finite=bool(torch.isfinite(got).all()),
                  argmax_agree=float((got.argmax(-1) == want.argmax(-1)).float().mean())))
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} {name}: non-finite kernel output")
    return worst


def dispatched(cfg, rows, logits_rows, extra=()) -> tuple[str, ...]:
    """The matmul wrappers dispatch picks (under the policy in force) for
    ``cfg``'s projections at each row count of ``rows``, its fp32 logits
    at each of ``logits_rows`` and the (m, k, n) bf16 calls of ``extra``."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv = (cfg.attn.n_heads * cfg.attn.head_dim, cfg.attn.n_kv_heads * cfg.attn.head_dim)
    wrapper = {"tiled": "matmul_tiled", "mcast": "matmul_mcast", "unicast": "matmul_unicast"}
    calls = [(m, k, n, torch.bfloat16) for m in rows
             for k, n in ((d, hq), (d, hkv), (hq, d), (d, f), (f, d))]
    calls += [(m, d, cfg.vocab, torch.float32) for m in logits_rows]
    calls += [(m, k, n, torch.bfloat16) for m, k, n in extra]
    return tuple(sorted({wrapper[kernels.resolve("matmul", (m, k, n), dt).schedule]
                         for m, k, n, dt in calls}))


def count_path(path: tuple[str, ...], label: str):
    """A context that sets every launch count to 0 and, on exit, fails
    unless exactly the kernels of ``path`` were launched; yields the
    counts."""
    @contextlib.contextmanager
    def ctx():
        counts: dict[str, int] = {}
        kernels.reset_launch_counts()
        yield counts
        counts.update(kernels.launch_counts())
        missing = [k for k in path if not counts[k]]
        stray = [k for k, v in counts.items() if v and k not in path]
        if missing or stray:
            raise AssertionError(f"{label}: kernels never launched {missing}, off the path "
                                 f"{stray}")
    return ctx()


def encdec_run(cfg, params, frames, prompt, forced=None):
    """The encoder-decoder's main path: encode and prefill, then
    ``ENCDEC_NEW`` greedy decode steps (or steps on the ``forced`` tokens)
    -> (logits of the prefill's last row and of every step (b, steps + 1,
    vocab), the tokens fed, the caches, the last step for timing)."""
    s = prompt.shape[1]
    logits, caches = encdec.prefill(params, cfg, prompt, frames, cache_slots=s + ENCDEC_NEW + 1)
    rows, toks = [logits[:, -1]], []
    for i in range(ENCDEC_NEW):
        tok = rows[-1].argmax(-1) if forced is None else forced[:, i]
        toks.append(tok)
        logits, caches = encdec.decode_step(params, cfg, caches, tok[:, None], s + i)
        rows.append(logits[:, -1])
    toks = torch.stack(toks, 1)

    def step():  # the last step again: it rewrites the same ring row
        return encdec.decode_step(params, cfg, caches, toks[:, -1:], s + ENCDEC_NEW - 1)[0]

    return torch.stack(rows, 1), toks, caches, step


def check_whisper(gen) -> dict[str, int]:
    """whisper-medium through ``models/encdec.py`` at full width and depth
    (24 + 24 layers): 1,500 seeded frames of 1,024 for a batch of 2, a
    16-token prompt, then 16 greedy decode steps — timed once unchecked
    with its launches counted (K1 only: attention is plain PyTorch), then
    with every layer held to the plain versions (:class:`LayerCheck`: the
    bidirectional encoder layers, self and cross attention, the cached
    cross attention, MLPs and logits), and the encoder output and each
    step's logits against a plain run fed the same tokens; where those
    leave ``TOL_MODEL``, a plain run on the frames with their last bit
    flipped says how far one ulp moves them."""
    cfg = get_config(WHISPER)
    params = build_model(encdec, cfg, "family_model")
    frames = torch.randn(2, cfg.encoder.n_frames, cfg.frontend_dim, device="cuda",
                         generator=gen).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (2, 16), device="cuda", generator=gen)
    tag = dict(arch=cfg.name, model="encdec", policy="default")
    b, s, t = 2, prompt.shape[1], cfg.encoder.n_frames
    # the encoder's rows (its input projection, layers and the cross K / V),
    # the decoder prefill's, a decode step's; the logits of one row a sequence
    path = dispatched(cfg, (b * t, b * s, b), (b,), extra=((b * t, cfg.frontend_dim, cfg.d_model),))
    with count_path(path, f"{cfg.name} encdec") as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_k, toks, _, step = encdec_run(cfg, params, frames, prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit(dict(check="encdec_run", **tag, batch=2, frames=cfg.encoder.n_frames,
              prompt=prompt.shape[1], new_tokens=ENCDEC_NEW, wall_s=wall,
              tokens_per_s=2 * ENCDEC_NEW / wall, path=path, launches=dict(launches)))
    wbytes = weight_bytes(params)
    emit(dict(check="decode_step_time", **tag, batch=2, context=prompt.shape[1] + ENCDEC_NEW,
              weight_bytes=wbytes, weight_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
              **step_stats(step, top=8)))
    check = LayerCheck()
    with check.armed():
        encdec_run(cfg, params, frames, prompt, forced=toks)
    hold_layers(tag, check, ENCDEC_NEW + 1)
    memory_k = encdec.encode(params, cfg, frames)
    with plain_versions():
        memory_p = encdec.encode(params, cfg, frames)
        logits_p = encdec_run(cfg, params, frames, prompt, forced=toks)[0]
    worst = hold_whole(tag, (("encode", memory_k, memory_p), ("prefill_and_steps", logits_k,
                                                               logits_p)))
    if worst > 1:
        flipped = (frames.view(torch.int16) ^ 1).view(torch.bfloat16)
        with plain_versions():
            memory_f = encdec.encode(params, cfg, flipped)
            logits_f = encdec_run(cfg, params, flipped, prompt, forced=toks)[0]
        for name, k, p, f in (("encode", memory_k, memory_p, memory_f),
                              ("prefill_and_steps", logits_k, logits_p, logits_f)):
            scale = TOL_MODEL * float(p.abs().max())
            emit(dict(check="flipped_bit_gap", name=name, **tag, kernels_over_tol=max_err(k, p)
                      / scale, flipped_bit_over_tol=max_err(f, p) / scale))
    del params
    free_model()
    return dict(launches)


def lm_greedy_run(cfg, params, tokens, frontend_embeds, steps: int, forced=None):
    """``lm.prefill`` of a batch (``frontend_embeds`` prepended) into rings
    of ``steps`` slots past it, then ``steps`` greedy decode steps on the
    dense caches (or steps on the ``forced`` tokens) -> (logits (b, steps
    + 1, vocab), tokens fed, the last step for timing)."""
    s = tokens.shape[1] + (0 if frontend_embeds is None else frontend_embeds.shape[1])
    logits, caches = lm.prefill(params, cfg, tokens, frontend_embeds=frontend_embeds,
                                cache_slots=s + steps)
    rows, toks = [logits[:, -1]], []
    for i in range(steps):
        tok = rows[-1].argmax(-1) if forced is None else forced[:, i]
        toks.append(tok)
        logits, caches = lm.decode_step(params, cfg, caches, tok[:, None], s + i)
        rows.append(logits[:, -1])
    toks = torch.stack(toks, 1)

    def step():
        return lm.decode_step(params, cfg, caches, toks[:, -1:], s + steps - 1)[0]

    return torch.stack(rows, 1), toks, step


def check_pixtral(gen) -> dict[str, int]:
    """pixtral-12b at full width and depth: ``lm.prefill`` over 256 seeded
    patch embeddings of 1,024 (through ``frontend_proj``) and a 32-token
    text prompt, batch 2, then 8 greedy decode steps on the dense caches —
    timed and counted unchecked, then every layer held to the plain
    versions (:class:`LayerCheck`), the logits of each step against a plain
    run fed the same tokens (reported)."""
    cfg = get_config("pixtral-12b")
    params = build_model(lm, cfg, "family_model")
    patches = torch.randn(2, 256, cfg.frontend_dim, device="cuda", generator=gen).to(
        torch.bfloat16)
    text = torch.randint(0, cfg.vocab, (2, 32), device="cuda", generator=gen)
    tag = dict(arch=cfg.name, kv="dense", policy="default", frontend_patches=256)
    steps = 8
    path = dispatched(cfg, (2 * (256 + 32), 2), (2,), extra=((2 * 256, cfg.frontend_dim,
                                                               cfg.d_model),))
    with count_path(path, f"{cfg.name} frontend") as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_k, toks, step = lm_greedy_run(cfg, params, text, patches, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit(dict(check="frontend_run", **tag, batch=2, prompt=256 + 32, new_tokens=steps,
              wall_s=wall, path=path, launches=dict(launches)))
    wbytes = weight_bytes(params)
    emit(dict(check="decode_step_time", **tag, batch=2, context=256 + 32 + steps,
              weight_bytes=wbytes, weight_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
              **step_stats(step, top=8)))
    check = LayerCheck()
    with check.armed():
        lm_greedy_run(cfg, params, text, patches, steps, forced=toks)
    hold_layers(tag, check, steps + 1)
    with plain_versions():
        logits_p = lm_greedy_run(cfg, params, text, patches, steps, forced=toks)[0]
    if hold_whole(tag, (("prefill_and_steps", logits_k, logits_p),)) > 1:
        check_depth_gap(cfg, params)
    del params
    free_model()
    return dict(launches)


def check_dense_family(arch: str, policies, serve: bool) -> dict[str, int]:
    """An arch at full width and depth on the dense path: the 45-token
    prefill and batch-4 decode step per policy under :class:`LayerCheck`
    with the whole-run comparison (:func:`check_dense_model`), the
    depth-gap witness where a whole run leaves ``TOL_MODEL``, and with
    ``serve`` the dense ``Server`` per policy against a plain run
    (:func:`check_dense_serving`)."""
    cfg = get_config(arch)
    params = build_model(lm, cfg, "family_model")
    if check_dense_model(cfg, params, policies) > 1:
        check_depth_gap(cfg, params)
    launches = check_dense_serving(cfg, params) if serve else {}
    del params
    free_model()
    return launches


def check_command_r(gen) -> dict[str, int]:
    """command-r-35b at full width and depth (60.6 GB of bf16) on the paged
    path, its 64 query heads over 8 KV heads (group 8, d 128): a bucketed
    45-token prefill into pages and a batch-4 decode step on them (K1, K2),
    and a prefix hit — a 28-token suffix prefilled over the pages of the
    prompt's first 32 tokens (K3 at group 8: 224 rows a KV head) — with
    every layer held to the plain versions (:class:`LayerCheck`) and the
    whole runs against plain ones (reported); then the paged engine over
    :func:`serving_requests` (8 prompts after a 32-token shared prefix:
    prefix hits, suffix prefills on K3 at group 8, decode on K2)."""
    cfg = get_config("command-r-35b")
    params = build_model(lm, cfg, "family_model")
    prompt = torch.randint(0, cfg.vocab, (45,), device="cuda", generator=gen)
    step_tokens = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)
    suffix = torch.randint(0, cfg.vocab, (28,), device="cuda", generator=gen)
    tag = dict(arch=cfg.name, kv="paged", policy="default", group=cfg.attn.n_heads
               // cfg.attn.n_kv_heads)
    pre_k, dec_k, stats = model_run(cfg, params, prompt, step_tokens, time_step=True)
    wbytes = weight_bytes(params)
    emit(dict(check="decode_step_time", **tag, batch=4, context=len(prompt) + 1,
              weight_bytes=wbytes, weight_bound_ms=wbytes / HBM_BYTES_PER_S * 1e3,
              logits_bytes=params["embed"]["table"].numel() * 2, **stats))
    suf_k = suffix_model_run(cfg, params, prompt[:32], suffix)
    check = LayerCheck()
    with check.armed():
        model_run(cfg, params, prompt, step_tokens)
        suffix_model_run(cfg, params, prompt[:32], suffix)
    hold_layers(tag, check, 4)  # the prefill's, the decode step's, the suffix's
    with plain_versions():
        pre_p, dec_p = model_run(cfg, params, prompt, step_tokens)
        suf_p = suffix_model_run(cfg, params, prompt[:32], suffix)
    worst = hold_whole(tag, (("prefill", pre_k, pre_p), ("decode_step", dec_k, dec_p),
                             ("suffix_prefill", suf_k, suf_p)))
    del pre_k, dec_k, pre_p, dec_p, suf_k, suf_p
    if worst > 1:
        check_depth_gap(cfg, params)
    paged = ("matmul_tiled", "paged_attention_decode", "paged_attention_prefill")
    launches = serve_path(f"{cfg.name} paged", PagedEngine(cfg, params, config=ServeConfig(),
                                                           device="cuda"),
                          serving_requests(cfg), paged)
    # the serving run's last K2 and K3 launches, at group 8
    emit(dict(check="paged_designs", arch=cfg.name, group=tag["group"],
              decode=_paged_design(paged_attention_decode, torch.bfloat16),
              prefill=_paged_design(paged_attention_prefill, torch.bfloat16)))
    del params
    free_model()
    return launches


def check_families(gen) -> dict[str, int]:
    """Phase 8: the new projections' rows, then one model at a time, each
    freed before the next is built: whisper-medium (encdec), pixtral-12b,
    gemma2-9b (dense ``Server`` under default / mcast / unicast),
    deepseek-7b (model check), command-r-35b (paged).  Returns each
    kernel's launches summed over the phase's main-path runs."""
    t0 = time.perf_counter()
    for label, k, n, kw in FAMILY_ROWS:
        for m in FAMILY_M:
            check_projection_row(gen, label, m, k, n, kw, check="family_matmul", tc_sum=True)
    for label, m, k, n, kw in FAMILY_WIDE_ROWS:
        check_projection_row(gen, label, m, k, n, kw, check="family_matmul", tc_sum=True)
    runs = [check_whisper(gen), check_pixtral(gen),
            check_dense_family("gemma2-9b", (None, "mcast", "unicast"), serve=True),
            check_dense_family("deepseek-7b", (None,), serve=False),
            check_command_r(gen)]
    emit(dict(check="phase", phase=8, seconds=time.perf_counter() - t0))
    return {k: sum(r.get(k, 0) for r in runs) for k in kernels.KERNELS}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 9: training — grad(grouped_linear) at moonshot's expert shapes, the
# tied head's three fp32 products at the training shape, train steps of
# qwen1.5-0.5b (full width and depth) per policy and of a 2-layer
# full-width moonshot, and the launcher through a crash and a resume
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
# the launcher's defaults: M = 1,024 tokens a step
TRAIN_BATCH, TRAIN_SEQ = 8, 128
# grad(grouped_linear) rows: phase 6's gate projection at a decode step's 24
# rows an expert and at a 512-token prompt's capacity of 60
GROUPED_GRAD_ROWS = (GROUPED_ROWS[0], GROUPED_ROWS[3])
# a train step's gradient leaves against the same step on the plain
# versions: relative L2 error within two bf16 ulps, or within the spread of
# the rounding model (plain_and_witnesses, spread: the largest distance
# between the plain run and two witnesses, the plain run with one ulp of
# its bf16 residual stream flipped at layer 0's input and at every layer's
# input); its loss within 1e-3 of the plain loss, or within that spread
GRAD_REL = 2e-2
LOSS_REL = 1e-3
# moonshot's depth in its training step: the dense first layer and one MoE
# layer.  At full depth its bf16 weights, their bf16 gradients and fp32
# moments take about 190 GB
MOE_TRAIN_LAYERS = 2
# the launcher run: 8 steps, a checkpoint every 4, a crash at step 6
LAUNCH_STEPS, LAUNCH_CKPT_EVERY, LAUNCH_CRASH_AT = 8, 4, 6
_PLAIN = {"matmul_tiled": matmul_tiled_plain, "matmul_mcast": matmul_mcast_plain,
          "matmul_unicast": matmul_unicast_plain}


@contextlib.contextmanager
def noting_matmuls(calls: list, plain: bool = False):
    """Route the kernel layer's three matmul wrappers (with ``plain``: the
    plain versions, as :func:`plain_versions` does) through a recorder:
    each call appends (wrapper name, args, keywords, output, the launch's
    design or None)."""
    def wrap(name):
        fn = _PLAIN[name] if plain else kernels.KERNELS[name]

        def run(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out, None if plain else kernels.KERNELS[name].design))
            return out
        return run

    with mock.patch.object(api, "matmul_tiled", wrap("matmul_tiled")), \
            mock.patch.object(api, "matmul_mcast", wrap("matmul_mcast")), \
            mock.patch.object(api, "matmul_unicast", wrap("matmul_unicast")):
        yield


def launch_record(name, args, kw, out, design) -> dict:
    """One matmul launch of a backward re-run on its own inputs: held to
    its plain version (fp32 outputs with the tensor cores' accumulation
    allowance over K), timed beside :func:`matmul_bound` and
    :func:`matmul_library` on the same (strided) operands."""
    a, b = args[:2]
    g, m, k = (1, *a.shape) if a.ndim == 2 else a.shape
    n = b.shape[-1]
    want = _PLAIN[name](*args, **kw)
    if out.dtype == torch.float32:
        err = check_close(f"{name} launch {g}x{m}x{k}x{n}", out, want, TOL_FP32,
                          tc_sum_allowance(want, k))
    else:
        err = check_close(f"{name} launch {g}x{m}x{k}x{n}", out, want, TOL_BF16)
    b_ms, b_by = matmul_bound(a, b, None, out.dtype)
    library, library_ms = matmul_library(a, b)
    fn = kernels.KERNELS[name]
    return dict(kernel=name, design=design, shape=[g, m, k, n], a_dtype=str(a.dtype),
                b_dtype=str(b.dtype), out_dtype=str(out.dtype),
                a_k_major=a.stride(-1) == 1, b_n_major=b.stride(-1) == 1,
                kernel_ms=time_ms(lambda: fn(*args, **kw), runs=10)[0],
                plain_ms=time_ms(lambda: _PLAIN[name](*args, **kw), runs=3)[0],
                library=library, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, max_err=err)


def check_grouped_grad(gen, policy: str, label, g, m, k, n, activation) -> dict[str, int]:
    """``grad(grouped_linear)`` with ``activation`` under a forced schedule
    (A (g, m, k), B (g, k, n), bf16): one grouped launch forward, then z,
    dA and dB backward, one grouped launch each (under ``backend=pallas``:
    K1).  Each backward launch is held to its plain version on its own
    inputs and timed beside its bound and ``torch.matmul`` on the same
    (strided) operands; dA and dB against the same graph on the plain
    versions, with :func:`check_linear_grad`'s allowance for the bf16 dz
    elements the two runs round apart.  Returns the launches."""
    x = torch.randn(g, m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(g, k, n, device="cuda", generator=gen) / math.sqrt(k)).to(torch.bfloat16)
    cot = torch.randn(g, m, n, device="cuda", generator=gen)

    def path():
        leaves = [t.detach().requires_grad_() for t in (x, w)]
        y = kernels.grouped_linear(*leaves, activation=activation, policy=policy)
        return (y, *torch.autograd.grad((y.float() * cot).sum(), leaves))

    forced = dict(zip(POLICIES, MATMULS))[policy]
    leaves = [t.detach().requires_grad_() for t in (x, w)]
    kernels.reset_launch_counts()
    y = kernels.grouped_linear(*leaves, activation=activation, policy=policy)
    fwd = kernels.launch_counts()
    fwd_design = kernels.KERNELS[forced].design
    calls, plain_calls = [], []
    with noting_matmuls(calls):
        grads = torch.autograd.grad((y.float() * cot).sum(), leaves)
    torch.cuda.synchronize()
    bwd = {name: cnt - fwd[name] for name, cnt in kernels.launch_counts().items()}
    if fwd[forced] != 1 or sum(fwd.values()) != 1 or sum(bwd.values()) != 3 \
            or bwd["matmul_tiled"] != 3 or any(c[1][0].ndim != 3 for c in calls):
        raise AssertionError(f"grad(grouped_linear) {policy} {label}: forward launched {fwd}, "
                             f"backward {bwd} (want 3 grouped K1 launches: z, dA, dB)")
    products = []
    for product, (name, args, kw, out, design) in zip(("z", "dA", "dB"), calls):
        products.append(dict(product=product, **launch_record(name, args, kw, out, design)))
    with plain_versions(), noting_matmuls(plain_calls, plain=True):
        want = path()
    # bf16 dz, the first operand of the dA product, in each run
    flips = (calls[1][1][0].double() - plain_calls[2][1][0].double()).abs()
    extra = {"dx": torch.bmm(flips, w.double().abs().transpose(1, 2)),
             "dw": torch.bmm(x.double().abs().transpose(1, 2), flips)}
    errs = [check_close(f"grad(grouped_linear) {policy} {label} {name}", got, ref, TOL_BF16,
                        extra.get(name))
            for name, got, ref in zip(("y", "dx", "dw"), (y, *grads), want)]
    emit(dict(check="grouped_grad", policy=policy, row=label, shape=[g, m, k, n],
              activation=activation, forward_launches={k_: v for k_, v in fwd.items() if v},
              backward_launches={k_: v for k_, v in bwd.items() if v},
              forward_design=fwd_design, backward=products,
              fwd_bwd_ms=time_ms(path, 10, max_spin_s=0.5)[0],
              plain_fwd_bwd_ms=time_ms(lambda: _plain_call(path), 3, max_spin_s=0.5)[0],
              dz_bf16_elements_differing=int((flips > 0).sum()),
              max_err_y_dx_dw=errs, tol=TOL_BF16))
    del extra, flips
    return {k_: fwd[k_] + bwd[k_] for k_ in fwd}


def _plain_call(fn):
    with plain_versions():
        return fn()


def check_logits_products(gen) -> list[dict]:
    """The tied head's three fp32 products at the training shape (M =
    batch x seq = 1,024 tokens, d 1,024, vocab 151,936), as a train step
    launches them: the forward (fp32 x, the bf16 table read as
    ``table.t()``), dA (fp32 dz x the bf16 table) and dB (``x.t()``,
    M-major fp32, x fp32 dz).  dz is the mean cross entropy's gradient of
    these logits over seeded labels.  Each held to its plain version at
    ``TOL_FP32`` x (|want| + the RMS of want's row) (dz's entries are
    ~1e-9: a fixed absolute term would pass anything), timed beside
    :func:`matmul_bound` (operations at the fp32-accurate tensor-core rate:
    the bound of the function on this card, not of the design that runs
    it; ``design_rate_ms`` is the same work at the CUDA-core fp32 rate of
    the ``cuda-core`` design, a note) and :func:`matmul_library`'s
    ``torch.matmul`` of the same operands with the bf16 table widened to
    fp32 beforehand (TF32 off)."""
    m, k, n = TRAIN_BATCH * TRAIN_SEQ, 1024, 151936
    table = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
    x = torch.randn(m, k, device="cuda", generator=gen)
    labels = torch.randint(0, n, (m,), device="cuda", generator=gen)
    logits = matmul_tiled_plain(x, table.t())
    dz = torch.softmax(logits, dim=-1)
    dz[torch.arange(m, device="cuda"), labels] -= 1.0
    dz /= m
    del logits
    out = []
    for product, a, b in (("forward", x, table.t()), ("dA", dz, table), ("dB", x.t(), dz)):
        before = matmul_tiled.launches
        got = matmul_tiled(a, b)
        if matmul_tiled.launches != before + 1:
            raise AssertionError(f"logits {product}: {matmul_tiled.launches - before} launches")
        design = matmul_tiled.design
        want = matmul_tiled_plain(a, b)
        err, ratio, fixed = check_flash_close(f"logits {product}", got, want, TOL_FP32)
        del got, want
        b_ms, b_by = matmul_bound(a, b, None, torch.float32)
        library, library_ms = matmul_library(a, b.float())
        mm, kk, nn_ = a.shape[0], a.shape[1], b.shape[1]
        rec = dict(check="train_logits", product=product, shape=[mm, kk, nn_],
                   a_dtype=str(a.dtype), b_dtype=str(b.dtype), a_k_major=a.stride(-1) == 1,
                   b_n_major=b.stride(-1) == 1, design=design,
                   kernel_ms=time_ms(lambda: matmul_tiled(a, b), runs=5, max_spin_s=0.5)[0],
                   plain_ms=time_ms(lambda: matmul_tiled_plain(a, b), runs=3,
                                    max_spin_s=0.5)[0],
                   library=f"{library} (fp32, TF32 off, B widened beforehand)",
                   library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                   design_rate_ms=2.0 * mm * nn_ * kk / PEAK_FP32 * 1e3,
                   max_err=err, err_over_allowance=ratio, least_fixed_atol=fixed, tol=TOL_FP32)
        emit(rec)
        out.append(rec)
    del table, dz
    torch.cuda.empty_cache()
    return out


def check_down_projection_db(gen) -> dict:
    """The down projection's weight gradient in a default train step, dB =
    hᵀ dz: (2,816 x 1,024 tokens) x (1,024 tokens x 1,024), hᵀ a view of
    the bf16 activations (M-major).  The default policy's cost model sends
    it to K4 (above 2,048 rows), whose ``wgmma-cluster`` design takes
    K-major A only, so K4 runs ``cuda-core``.  Held to its plain version
    and timed beside :func:`matmul_bound` and ``torch.matmul`` on the same
    strided operands (:func:`launch_record`)."""
    m_tok, d_ff, d = TRAIN_BATCH * TRAIN_SEQ, 2816, 1024
    h = torch.randn(m_tok, d_ff, device="cuda", generator=gen).to(torch.bfloat16)
    dz = (torch.randn(m_tok, d, device="cuda", generator=gen) * 1e-3).to(torch.bfloat16)
    pick = kernels.resolve("matmul", (d_ff, m_tok, d), torch.bfloat16)
    before = matmul_mcast.launches
    out = matmul_mcast(h.t(), dz)
    if pick.schedule != "mcast" or matmul_mcast.launches != before + 1:
        raise AssertionError(f"down projection dB: dispatch picks {pick.schedule}")
    rec = dict(check="train_down_projection_db", dispatch=pick.schedule,
               **launch_record("matmul_mcast", (h.t(), dz), {}, out, matmul_mcast.design))
    emit(rec)
    del h, dz, out
    return rec


def flip_last_bit(x: torch.Tensor) -> torch.Tensor:
    """``x`` with the last mantissa bit of every element flipped (one ulp
    of its dtype), the gradient passed straight through to ``x``."""
    d = x.detach()
    ints = torch.int16 if d.element_size() == 2 else torch.int32
    return x + ((d.view(ints) ^ 1).view(d.dtype) - d)


def _flip_output(real):
    """``real`` with the last bit of every element of its output flipped."""
    return lambda *args, **kw: flip_last_bit(real(*args, **kw))


def _flip_layer_input(real_layer):
    """``lm._layer`` with the last bit of every element of its input
    flipped."""
    return lambda p, bd, cfg, x: real_layer(p, bd, cfg, flip_last_bit(x))


#: perturbed plain runs (``lm`` functions patched): one ulp flipped in
#: every element of the residual stream at layer 0's input (``layer 0``)
#: or at every layer's input (``every layer``)
WITNESSES = {"layer 0": ("_embed_inputs", _flip_output),
             "every layer": ("_layer", _flip_layer_input)}
#: the gate's rounding model: two members of one family, the plain run with
#: one ulp of its residual stream flipped, once where the stream starts and
#: once at every layer (where the kernel and plain runs each round their
#: own layer outputs into bf16)
GATE_WITNESSES = ("layer 0", "every layer")


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def plain_and_witnesses(bundle, params, batch, names=GATE_WITNESSES) -> tuple:
    """(loss, gradients) of ``bundle``'s step on the plain versions, and
    the same of each witness of ``names`` (:data:`WITNESSES`)."""
    runs = []
    with plain_versions():
        plain = value_and_grad(bundle.loss_of, params, batch)
        for name in names:
            site, flip = WITNESSES[name]
            with mock.patch.object(lm, site, flip(getattr(lm, site))):
                runs.append(value_and_grad(bundle.loss_of, params, batch))
    return plain, runs


def spread(plain: torch.Tensor, witnesses) -> float:
    """How far runs of the rounding model lie apart, relative to the plain
    run: the largest distance between any two of the plain run and the
    witnesses, over ``|plain|``.  The kernel run is one more member of the
    model's family (the plain run with its roundings moved by an ulp), so
    it should lie no farther from the plain run than two members lie from
    each other.  A leaf any run of which is not finite gets nan."""
    runs = [plain, *witnesses]
    norm = plain.float().norm().clamp(min=1e-30)
    return max(float((a.float() - b.float()).norm() / norm)
               for i, a in enumerate(runs) for b in runs[i + 1:])


def leaf_gaps(params, grads, plain, witnesses) -> list[tuple[float, str, float]]:
    """(rel L2 of ``grads`` against ``plain``, the leaf's path, the
    :func:`spread` of ``plain`` and the ``witnesses``' gradients) for every
    gradient leaf."""
    return [(_rel(g, p), path, spread(p, ws)) for path, g, p, *ws in zip(
        flatten_with_paths(params), _leaves(grads), _leaves(plain),
        *(_leaves(w) for w in witnesses))]


def leaf_passes(rel: float, wit: float) -> bool:
    """The gradient gate of a train step: a finite gap within ``GRAD_REL``
    or the rounding model's spread (:func:`spread`)."""
    return math.isfinite(rel) and (rel <= GRAD_REL or rel <= wit)


def check_train_step(cfg, params, batch, policy=None, label="") -> dict[str, int]:
    """One train step's loss and gradients (``build_train_step``'s loss,
    ``dist.step.value_and_grad``) through the kernels under ``policy``,
    held leaf by leaf to the same step on the plain versions
    (:func:`leaf_passes`: ``GRAD_REL``, or the :func:`spread` of the
    flipped-ulp witnesses of :func:`plain_and_witnesses`); the launches by kernel and the K1 designs
    of the kernel run.  Returns the kernel run's launches."""
    bundle = build_train_step(cfg, ShapeCfg("chip", "train", *batch["tokens"].shape[::-1]),
                              loss_chunk=None)
    pol = kernels.use_policy(policy) if policy else contextlib.nullcontext()
    calls = []
    with pol:
        kernels.reset_launch_counts()
        with noting_matmuls(calls):
            loss, grads = value_and_grad(bundle.loss_of, params, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        (p_loss, p_grads), witnesses = plain_and_witnesses(bundle, params, batch)
    rows = leaf_gaps(params, grads, p_grads, [w[1] for w in witnesses])
    for rel, path, wit in rows:
        if not leaf_passes(rel, wit):
            raise AssertionError(f"train step {cfg.name} {policy or 'default'}: gradient {path} "
                                 f"rel L2 {rel:.3g} beyond {GRAD_REL} and the spread {wit:.3g}")
    worst = max(r[0] for r in rows)
    worst_allowance = max(r[0] / max(GRAD_REL, r[2]) for r in rows)
    loss_gap = abs(float(loss) - float(p_loss))
    loss_wit = spread(p_loss, [w[0] for w in witnesses]) * abs(float(p_loss))
    if not (math.isfinite(float(loss)) and (loss_gap <= LOSS_REL * abs(float(p_loss))
                                            or loss_gap <= loss_wit)):
        raise AssertionError(f"train step {cfg.name} {policy or 'default'}: loss {float(loss)} "
                             f"vs plain {float(p_loss)} (spread {loss_wit})")
    designs = collections.Counter(f"{c[0]}:{c[4]}" for c in calls)
    emit(dict(check="train_step_grads", arch=cfg.name, row=label, layers=cfg.n_layers,
              policy=policy or "default", batch=list(batch["tokens"].shape),
              loss=float(loss), plain_loss=float(p_loss),
              witness_losses=[float(w[0]) for w in witnesses],
              leaves=len(rows), worst_rel_l2=worst, worst_over_allowance=worst_allowance,
              worst_leaves=[dict(leaf=p_, rel_l2=r, spread=w_)
                            for r, p_, w_ in sorted(rows, reverse=True)[:4]],
              grad_rel=GRAD_REL, launches={k_: v for k_, v in launches.items() if v},
              matmul_designs=dict(designs)))
    del grads, p_grads, witnesses
    return launches


def time_train_step(cfg, params, batch) -> dict:
    """One AdamW step split as ``dist.step``'s train step runs it: the
    loss (forward), ``torch.autograd.grad`` (backward) and
    ``adamw.update`` (optimizer), each part's host ms (the wall time to
    enqueue it) and device ms (CUDA events around it: the span, waits for
    the host included), after a synchronised start; then the whole step
    under ``torch.profiler`` (device ops and their summed ms, the top
    ops), its launches by kernel and the peak memory."""
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=LAUNCH_STEPS)
    bundle = build_train_step(cfg, ShapeCfg("chip", "train", TRAIN_SEQ, TRAIN_BATCH),
                              opt_cfg=opt_cfg, loss_chunk=None)
    params = map_structure(lambda p: p.detach().clone().requires_grad_(), params)
    opt_state = adamw.init(params, opt_cfg)
    leaves = list(_leaves(params))

    def split(step):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        host = [time.perf_counter()]
        ev[0].record()
        with torch.enable_grad():
            loss = bundle.loss_of(params, batch)
        ev[1].record()
        host.append(time.perf_counter())
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        host.append(time.perf_counter())
        it = iter(grads)
        adamw.update(map_structure(lambda _: next(it), params), opt_state, params, step, opt_cfg)
        ev[3].record()
        host.append(time.perf_counter())
        torch.cuda.synchronize()
        host.append(time.perf_counter())
        return ([ev[i].elapsed_time(ev[i + 1]) for i in range(3)],
                [1e3 * (host[i + 1] - host[i]) for i in range(3)], 1e3 * (host[4] - host[0]))

    for step in range(2):  # warm-up: the allocator, the memoised schedule picks
        split(step)
    runs = [split(2 + i) for i in range(5)]
    med = lambda xs: statistics.median(xs)  # noqa: E731
    device = [med([r[0][i] for r in runs]) for i in range(3)]
    host = [med([r[1][i] for r in runs]) for i in range(3)]
    wall = med([r[2] for r in runs])
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    bundle.fn(params, opt_state, batch, 7)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(lambda: bundle.fn(params, opt_state, batch, 8), top=8)
    rec = dict(check="train_step_time", arch=cfg.name, layers=cfg.n_layers,
               batch=[TRAIN_BATCH, TRAIN_SEQ], tokens=TRAIN_BATCH * TRAIN_SEQ,
               device_ms_fwd_bwd_opt=device, host_ms_fwd_bwd_opt=host, step_wall_ms=wall,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (wall / 1e3),
               launches={k_: v for k_, v in launches.items() if v},
               peak_memory_gb=peak / 1e9, **prof)
    emit(rec)
    del params, opt_state
    return rec


def check_launcher() -> dict[str, int]:
    """``launch.train.main`` on the card at the launcher's defaults
    (qwen1.5-0.5b, batch 8, seq 128, seed 0): ``LAUNCH_STEPS`` steps with a
    checkpoint every ``LAUNCH_CKPT_EVERY``, crashed at ``LAUNCH_CRASH_AT``
    (its ``RuntimeError`` is the check), then ``--resume``: restarts from
    the step-4 checkpoint and runs to the end.  Losses finite; whether they
    fall after the warmup is a reading.  Returns the launches of both
    runs."""
    import io
    import os
    import tempfile

    from repro_torch.launch import train as train_launcher

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", TRAIN_ARCH, "--steps", str(LAUNCH_STEPS), "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--ckpt-every", str(LAUNCH_CKPT_EVERY),
                "--log-every", "1", "--ckpt-dir", d, "--seed", "0"]
        first, second = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(first):
                train_launcher.main([*args, "--simulate-failure-at", str(LAUNCH_CRASH_AT)])
        except RuntimeError as e:
            if str(e) != f"simulated node failure at step {LAUNCH_CRASH_AT}":
                raise
        else:
            raise AssertionError("the launcher ran past --simulate-failure-at")
        with contextlib.redirect_stdout(second):
            out = train_launcher.main([*args, "--resume"])
        steps = sorted(int(n[5:]) for n in os.listdir(d) if n.startswith("step_"))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    lines = first.getvalue().splitlines() + second.getvalue().splitlines()
    crashed = [float(ln.split()[3]) for ln in first.getvalue().splitlines()
               if ln.startswith("step ")]
    resumed = out["losses"]
    want_resume = (LAUNCH_CRASH_AT // LAUNCH_CKPT_EVERY) * LAUNCH_CKPT_EVERY
    if second.getvalue().splitlines()[0] != f"resuming from checkpoint step {want_resume}" \
            or out["start"] != want_resume or len(crashed) != LAUNCH_CRASH_AT \
            or len(resumed) != LAUNCH_STEPS - want_resume \
            or not all(math.isfinite(v) for v in crashed + resumed) \
            or steps != [LAUNCH_STEPS - LAUNCH_CKPT_EVERY, LAUNCH_STEPS]:
        raise AssertionError(f"launcher: crash / resume went wrong: {lines}, checkpoints {steps}")
    secs = out["step_seconds"]
    emit(dict(check="train_launcher", arch=TRAIN_ARCH, steps=LAUNCH_STEPS,
              crash_at=LAUNCH_CRASH_AT, resumed_from=out["start"], checkpoints_kept=steps,
              losses_before_crash=crashed, losses_after_resume=resumed,
              resumed_first_equals_crashed_run=f"{resumed[0]:.4f}" == f"{crashed[want_resume]:.4f}",
              falls_after_warmup=resumed[-1] < crashed[5 if LAUNCH_CRASH_AT > 5 else -1],
              resumed_step_seconds=secs,
              tokens_per_s_median_resumed=TRAIN_BATCH * TRAIN_SEQ / statistics.median(secs),
              launches={k_: v for k_, v in launches.items() if v},
              seconds=time.perf_counter() - t0, stdout=lines))
    return launches


def check_embed_grad_accumulation() -> None:
    """How the embedding lookup's backward sums a repeated token's
    gradient rows on the card (one side of the tied table's gradient; the
    head's dB, summed in fp32 and rounded once, is the other): 3,000
    copies of 0.01 into one bf16 row.  fp32 accumulation rounded once
    gives 30; bf16 rounding after every add stalls at 4, as both packages
    do on the CPU (a reading, not a check)."""
    t = torch.zeros(4, 8, dtype=torch.bfloat16, device="cuda", requires_grad=True)
    rows = t[torch.zeros(3000, dtype=torch.long, device="cuda")]
    g, = torch.autograd.grad(rows.float().sum() * 0.01, [t])
    emit(dict(check="embed_grad_accumulation", copies=3000, each=0.01,
              got=float(g[0, 0]), fp32_once=30.0, bf16_every_add=4.0))


def check_training(gen) -> dict[str, int]:
    """Phase 9; returns each kernel's launches over the main-path runs
    (the launcher, the train steps through the kernels)."""
    t0 = time.perf_counter()
    total = collections.Counter()
    check_embed_grad_accumulation()
    for label, g, m, k, n, act in GROUPED_GRAD_ROWS:
        for policy in POLICIES:
            check_grouped_grad(gen, policy, label, g, m, k, n, act)
    check_logits_products(gen)

    cfg = get_config(TRAIN_ARCH)
    params = lm.init(cfg, seed=0, device="cuda")
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    batch = data_batch(data_cfg, 0, "cuda")
    for policy in (None, "mcast", "unicast"):
        total.update(check_train_step(cfg, params, batch, policy, label="qwen full depth"))
    time_train_step(cfg, params, batch)
    del params
    torch.cuda.empty_cache()
    total.update(check_launcher())

    cfg_moe = cut_depth(get_config(MOE_ARCH), {"layers": []}, MOE_TRAIN_LAYERS)[0]
    params_moe = lm.init(cfg_moe, seed=0, device="cuda")
    moe_batch = data_batch(DataConfig(vocab=cfg_moe.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0), 0, "cuda")
    total.update(check_train_step(cfg_moe, params_moe, moe_batch, label=(
        f"depth cut to {MOE_TRAIN_LAYERS} of 48 layers: at full depth the weights, their "
        f"gradients and fp32 moments need about 190 GB")))
    del params_moe
    torch.cuda.empty_cache()
    check_down_projection_db(gen)
    emit(dict(check="phase", phase=9, seconds=time.perf_counter() - t0))
    return {k_: total[k_] for k_ in kernels.KERNELS}


# ---------------------------------------------------------------------------
# phase 10: the trace tooling on the card — the launchers' --trace, the
# dispatch records, obs.export and obs.analyze at full width
# ---------------------------------------------------------------------------

#: the traced launcher runs (full width; weights and requests from the
#: launchers' own seeds, nothing from the shared generator): (a) the paged
#: engine with a shared prefix, (b) qwen1.5-1.8b speculating with its
#: registered draft, (c) the async ServeLoop over a seeded Poisson trace
#: (no shared prefix: every prefill is cold whatever the arrival timing,
#: so the streams cannot depend on it), (d) two training steps
TRACE_RUNS = {
    "paged": ["--arch", "qwen1.5-0.5b", "--kv", "paged", "--requests", "8", "--max-new", "16",
              "--shared-prefix", "32", "--seed", "0"],
    "spec": ["--arch", "qwen1.5-1.8b", "--kv", "paged", "--spec-k", "4", "--draft-model", "auto",
             "--requests", "8", "--max-new", "16", "--shared-prefix", "32", "--seed", "0"],
    "server": ["--arch", "qwen1.5-0.5b", "--server", "--qps", "4", "--duration", "2",
               "--max-slots", "4", "--max-new", "16", "--seed", "0"],
}
TRACE_TRAIN = ["--arch", "qwen1.5-0.5b", "--steps", "2", "--batch", str(TRAIN_BATCH),
               "--seq", str(TRAIN_SEQ), "--log-every", "1", "--seed", "0"]
#: the trace's unit, in ms: its timestamps are microseconds
TRACE_RESOLUTION_MS = 1e-3


class TimedEngine(PagedEngine):
    """``PagedEngine`` timing each ``step()`` (wall ms: the steps are
    host-bound) and bracketing each model step's dispatch with CUDA
    events recorded where its ``engine.<name>`` span opens and closes."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.step_ms, self.marks = [], []
        TimedEngine.made.append(self)

    def step(self):
        t0 = time.perf_counter()
        out = super().step()
        self.step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def _dispatch(self, name, *args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = super()._dispatch(name, *args)
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[1].record()
        self.marks.append((name, host_ms, *ev))
        return out


#: a span closed before the device finished the work it enqueued when the
#: device's time between the span's two events passes the span's host time
#: by more than this (ms): event timestamps resolve about half a microsecond
SPAN_LAG_MS = 0.1


def span_ends(marks) -> dict:
    """Per model step kind: the median host ms of its ``engine.*`` span,
    the median device ms between the span's two events (from the span's
    start until the device has run all the work the span enqueued: never
    less than the host ms, as the end event is recorded when the span
    closes), the median and largest lag of the device past the span's
    end, and the share of spans that closed more than ``SPAN_LAG_MS``
    before the device finished their work."""
    out = collections.defaultdict(list)
    for name, host_ms, e0, e1 in marks:
        out[name].append((host_ms, e0.elapsed_time(e1)))
    return {name: dict(spans=len(v), host_ms_p50=statistics.median(h for h, _ in v),
                       device_ms_p50=statistics.median(d for _, d in v),
                       lag_ms_p50=statistics.median(d - h for h, d in v),
                       lag_ms_max=max(d - h for h, d in v),
                       closed_before_device=sum(d - h > SPAN_LAG_MS for h, d in v) / len(v))
            for name, v in out.items()}


def _quiet(fn, *args, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn(*args, **kw)
    return res, out.getvalue(), err.getvalue()


def read_trace(path: str) -> tuple[dict, dict]:
    """The trace at ``path`` validated, with its analysis; fails unless
    nothing was dropped."""
    from repro_torch.obs import analyze as obs_analyze
    from repro_torch.obs import export as obs_export

    trace = obs_export.validate_trace(obs_export.load(path))
    report = obs_analyze.analyze(trace)
    if trace["metadata"]["n_dropped"] or report["trace_dropped"]:
        raise AssertionError(f"trace {path}: {trace['metadata']['n_dropped']} events dropped")
    return trace, report


def trace_summary(trace: dict, report: dict) -> dict:
    """Event counts by name, dispatch spans by ``<op>_<schedule>`` and by
    design, and the B-fetch share the tiles avoid."""
    events = trace["traceEvents"]
    disp = [e["args"] for e in events if e["ph"] == "X" and e["name"].startswith("dispatch.")]
    return dict(events=len(events),
                events_by_name=dict(collections.Counter(e["name"] for e in events).most_common(12)),
                dispatch_by_schedule=dict(collections.Counter(
                    f"{a['op']}_{a['schedule']}" for a in disp)),
                dispatch_by_design=dict(collections.Counter(
                    f"{a['op']}_{a['schedule']}:{a.get('design')}" for a in disp)),
                matmul_b_fetch_avoided_frac=report["matmul_b_fetch_avoided_frac"],
                matmul_b_block_fetches=report["matmul_b_block_fetches"],
                matmul_b_block_fetches_unicast=report["matmul_b_block_fetches_unicast"])


def hold_equal(label: str, pairs: dict) -> None:
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"trace {label}: report != live counters: {bad}")


#: each launcher runs untraced and traced twice over, alternating, so that
#: the step's wall ms with and without tracing are read through the host's
#: drift (one pair alone moved it by a third)
TRACE_ORDER = (False, True, False, True)


def check_traced_serving(label: str, args: list[str], d: str) -> dict[str, int]:
    """The launcher run of ``args`` untraced and with ``--trace``, in
    ``TRACE_ORDER``: stdout (the token streams) equal in every run; the last
    traced run's trace and report valid, nothing dropped; its report's
    kernel calls, pool and prefix keys (and the speculation keys, or the
    loop's TTFT decomposition) equal to its engine's live counters; the
    step's wall ms with and without tracing; where each ``engine.*`` span
    closes against the device work.  Returns the last traced run's
    launches."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.obs import analyze as obs_analyze

    path = f"{d}/{label}.json"
    runs = []
    for i, traced in enumerate(TRACE_ORDER):
        extra = ["--trace", path] if traced else []
        if label == "server":
            extra += ["--metrics-json", f"{d}/{label}{i}.metrics.json"]
        TimedEngine.made.clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(serve_launcher, "PagedEngine", TimedEngine):
            _, out, _ = _quiet(serve_launcher.main, [*args, *extra])
        torch.cuda.synchronize()
        runs.append(dict(traced=traced, out=out, engine=TimedEngine.made[-1],
                         launches=kernels.launch_counts(), seconds=time.perf_counter() - t0,
                         metrics=f"{d}/{label}{i}.metrics.json"))
    run = runs[-1]
    if any(r["out"] != run["out"] for r in runs) or "req " not in run["out"]:
        raise AssertionError(f"trace {label}: the traced runs' streams differ from the "
                             f"untraced runs'")
    used = {k for k, v in run["launches"].items() if v}
    if not used or any({k for k, v in r["launches"].items() if v} != used for r in runs):
        raise AssertionError(f"trace {label}: launches {[r['launches'] for r in runs]}")
    trace, report = read_trace(path)
    written = json.load(open(path + ".report.json"))
    obs_analyze.validate_report(written)
    eng = run["engine"]
    calls = {f"kernel_calls_{k}": (report.get(f"kernel_calls_{k}"), v)
             for k, v in eng.kernel_calls.items()}
    hold_equal(label, dict(
        calls, kernel_calls_total=(report["kernel_calls_total"], sum(eng.kernel_calls.values())),
        pool_pages_allocated=(report["pool_pages_allocated"], eng.pool.stats.allocated),
        pool_pages_freed=(report["pool_pages_freed"], eng.pool.stats.freed),
        pool_pages_shared=(report["pool_pages_shared"], eng.pool.stats.shared),
        pool_cow_copies=(report["pool_cow_copies"], eng.pool.stats.cow_copies),
        prefix_hit_tokens=(report["prefix_hit_tokens"], eng.prefix.hit_tokens),
        prefix_miss_tokens=(report["prefix_miss_tokens"], eng.prefix.miss_tokens),
        written_report=(written, report)))
    extra = {}
    if label == "spec":
        st = eng.stats()
        hold_equal(label, {k: (report[k], st[k]) for k in (
            "spec_rounds", "spec_drafted", "spec_accepted", "spec_rollback_pages")} | dict(
            spec_accept_rate=(report["spec_accept_rate"], st["accept_rate"])))
        if not report["spec_rounds"]:
            raise AssertionError("trace spec: no speculative round ran")
        extra = {k: report[k] for k in ("spec_rounds", "spec_drafted", "spec_accepted",
                                        "spec_accept_rate")}
    if label == "server":
        snaps = [json.load(open(r["metrics"])) for r in runs]
        snap = snaps[-1]
        gap = abs(report["ttft_decomposed_p50_ms"] - snap["ttft_p50_ms"])
        hold_equal(label, dict(requests=(report["requests_submitted"], snap["requests_total"]),
                               finished=(report["requests_finished"], snap["requests_total"]),
                               tokens=(report["tokens_emitted"], snap["tokens_out"]),
                               ticks=(report["decode_ticks"], snap["decode_ticks"])))
        if gap > TRACE_RESOLUTION_MS:
            raise AssertionError(f"trace server: TTFT p50 {report['ttft_decomposed_p50_ms']} "
                                 f"from spans vs {snap['ttft_p50_ms']} from the metrics")
        extra = dict(ttft_decomposed_p50_ms=report["ttft_decomposed_p50_ms"],
                     ttft_p50_ms_metrics=snap["ttft_p50_ms"], ttft_gap_ms=gap,
                     itl_p50_ms_by_run=[x["itl_p50_ms"] for x in snaps],
                     queue_wait_p50_ms=report["queue_wait_p50_ms"])
    step = [statistics.median(r["engine"].step_ms) for r in runs]
    emit(dict(check="trace_serving", run=label, args=args, **trace_summary(trace, report),
              order=["traced" if t else "untraced" for t in TRACE_ORDER],
              step_ms_p50_by_run=step,
              step_ms_p50_untraced=statistics.median(x for x, t in zip(step, TRACE_ORDER)
                                                     if not t),
              step_ms_p50_traced=statistics.median(x for x, t in zip(step, TRACE_ORDER) if t),
              steps=[len(r["engine"].step_ms) for r in runs],
              run_seconds_by_run=[r["seconds"] for r in runs],
              span_ends=span_ends(eng.marks),
              kernel_calls=dict(eng.kernel_calls), **extra,
              launches={k: v for k, v in run["launches"].items() if v}))
    launches = run["launches"]
    del runs, run, eng
    TimedEngine.made.clear()
    return launches


def check_traced_training(d: str) -> dict[str, int]:
    """``launch.train`` for two steps, untraced and with ``--trace`` in
    ``TRACE_ORDER``: equal losses and launches in every run, a valid trace
    with nothing dropped, its dispatch spans (forward and the backward's
    re-dispatch, one per call), the second step's wall ms with and without
    tracing (the first carries the run's warm-up).  Returns the last
    traced run's launches."""
    from repro_torch.launch import train as train_launcher

    runs = []
    for i, traced in enumerate(TRACE_ORDER):
        extra = ["--trace", f"{d}/train.json"] if traced else []
        kernels.reset_launch_counts()
        res, _, _ = _quiet(train_launcher.main, [*TRACE_TRAIN, "--ckpt-dir", f"{d}/ckpt{i}",
                                                 *extra])
        torch.cuda.synchronize()
        runs.append((res, kernels.launch_counts()))
    res, launches = runs[-1]
    if any(r["losses"] != res["losses"] or lc != launches for r, lc in runs) \
            or not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"trace train: losses {[r['losses'] for r, _ in runs]}")
    trace, report = read_trace(f"{d}/train.json")
    step = [1e3 * r["step_seconds"][-1] for r, _ in runs]
    emit(dict(check="trace_training", args=TRACE_TRAIN, losses=res["losses"],
              **trace_summary(trace, report),
              order=["traced" if t else "untraced" for t in TRACE_ORDER],
              last_step_ms_by_run=step,
              step_ms_untraced=statistics.median(x for x, t in zip(step, TRACE_ORDER) if not t),
              step_ms_traced=statistics.median(x for x, t in zip(step, TRACE_ORDER) if t),
              launches={k: v for k, v in launches.items() if v}))
    return launches


#: the record-cost reading: calls in each timed block, blocks each way
COST_CALLS, COST_BLOCKS = 500, 10
#: the paged run with tracing armed on every other engine step: longer
#: streams than ``TRACE_RUNS["paged"]`` for more pairs of steps
ALTERNATING_RUN = [*TRACE_RUNS["paged"][:-6], "--max-new", "64", *TRACE_RUNS["paged"][-4:]]


class AlternatingEngine(TimedEngine):
    """``TimedEngine`` with :attr:`rec` armed on every odd-numbered step
    only, the events each armed step records counted."""

    rec = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.armed_events = []

    def step(self):
        from repro_torch.obs import trace as obs_trace

        if len(self.step_ms) % 2 == 0:
            return super().step()
        n0 = len(self.rec)
        obs_trace.start(self.rec)
        try:
            return super().step()
        finally:
            obs_trace.stop()
            self.armed_events.append(len(self.rec) - n0)


def per_call_us(fn, n: int = COST_CALLS) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def check_tracing_cost(gen) -> None:
    """What tracing costs this card's host, each reading inside one
    process so that the host's drift between runs stays out of it:

    * per call, the medians over ``COST_BLOCKS`` blocks: one unarmed
      ``trace.active()`` check; ``kernels.linear`` at decode q/k/v's shape
      (4 x 1,024 x 1,024, bf16) in blocks alternating unarmed and armed,
      the difference being what tracing adds to a dispatched call; one
      ``_record_dispatch`` of that call's launch (its design and tile
      read) on a recorder;
    * per engine step: the paged launcher (``ALTERNATING_RUN``) with a
      recorder armed on every other step; each armed step's wall ms less
      the mean of its two unarmed neighbours, the median of those
      differences, and the events an armed step records.

    A measurement: it gates nothing but the run itself."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.obs import trace as obs_trace

    active_us = statistics.median(per_call_us(obs_trace.active) for _ in range(COST_BLOCKS))
    x = torch.randn(4, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn(1024, 1024, device="cuda", generator=gen) / 32).to(torch.bfloat16)
    linear_us = {False: [], True: []}
    for _ in range(COST_BLOCKS):
        for armed in (False, True):
            torch.cuda.synchronize()
            with (obs_trace.tracing() if armed else contextlib.nullcontext()):
                linear_us[armed].append(per_call_us(lambda: kernels.linear(x, w)))
            torch.cuda.synchronize()
    problem = api.Problem((4, 1024, 1024), "bfloat16")
    sched = kernels.op("matmul").resolve(problem)  # the schedule linear ran above
    wrapper = kernels.KERNELS[sched.kernel]
    rec = obs_trace.Recorder()
    record_us = statistics.median(
        per_call_us(lambda: api._record_dispatch(rec, rec.now(), "matmul", sched, problem,
                                                 wrapper.launches - 1))
        for _ in range(COST_BLOCKS))
    AlternatingEngine.rec = obs_trace.Recorder()
    TimedEngine.made.clear()
    with mock.patch.object(serve_launcher, "PagedEngine", AlternatingEngine):
        _, out, _ = _quiet(serve_launcher.main, ALTERNATING_RUN)
    torch.cuda.synchronize()
    eng = TimedEngine.made[-1]
    ms = eng.step_ms
    diffs = [ms[j] - (ms[j - 1] + ms[j + 1]) / 2 for j in range(1, len(ms) - 1, 2)]
    if "req " not in out or not diffs or not all(eng.armed_events):
        raise AssertionError(f"trace cost: run {len(ms)} steps, armed events "
                             f"{eng.armed_events}")
    events = statistics.median(eng.armed_events[:len(diffs)])
    diff_ms = statistics.median(diffs)
    unarmed, armed = (statistics.median(linear_us[k]) for k in (False, True))
    emit(dict(check="trace_cost", active_check_us=active_us, dispatch_record_us=record_us,
              linear_us_unarmed=unarmed, linear_us_armed=armed,
              linear_us_by_block={str(k): v for k, v in linear_us.items()},
              linear_tracing_us=armed - unarmed,
              alternating_args=ALTERNATING_RUN, steps=len(ms), step_pairs=len(diffs),
              step_ms_p50_unarmed=statistics.median(ms[0::2]),
              step_ms_p50_armed=statistics.median(ms[1::2]),
              armed_step_minus_neighbours_ms_p50=diff_ms,
              armed_step_minus_neighbours_ms=diffs,
              events_per_armed_step_p50=events,
              us_per_event_from_steps=1e3 * diff_ms / events,
              step_ms_predicted_from_records=events * record_us / 1e3))
    AlternatingEngine.rec = None
    TimedEngine.made.clear()


def check_trace_tooling() -> dict[str, int]:
    """Phase 10; returns each kernel's launches over its traced runs."""
    import tempfile

    t0 = time.perf_counter()
    check_tracing_cost(torch.Generator(device="cuda").manual_seed(10))
    total = collections.Counter()
    with tempfile.TemporaryDirectory() as d:
        for label, args in TRACE_RUNS.items():
            total.update(check_traced_serving(label, args, d))
            torch.cuda.empty_cache()
        total.update(check_traced_training(d))
    torch.cuda.empty_cache()
    emit(dict(check="phase", phase=10, seconds=time.perf_counter() - t0))
    return {k_: total[k_] for k_ in kernels.KERNELS}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False — this check needs a "
                 "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain fp32 path stays fp32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    build_s = _build.build_all()
    emit(dict(check="build", seconds=build_s, flags=" ".join(_build.NVCC_FLAGS)))
    for kname in _build.KERNELS:
        for entry, props in ptxas_entries(_build.ptxas_report(kname)):
            print(f"# ptxas {kname}: {entry}: {props}", flush=True)

    count_reference_calls()
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    mm = [check_matmul(gen, 4, 1024, 1024),                      # decode q/k/v (+bias)
          check_matmul(gen, 4, 1024, 2816, bias=False, activation="silu"),  # decode gate
          check_matmul(gen, 4, 2816, 1024, bias=False),          # decode down projection
          check_matmul(gen, 48, 1024, 2816, bias=False, activation="silu"),  # prefill gate
          check_matmul(gen, 4, 1024, 151936, logits=True)]       # tied logits, fp32
    summary["matmul_tiled"] = mm[0]
    for label, m, k, n, kw in PAIR_MATMUL_ROWS:
        check_matmul(gen, m, k, n, label=label, **kw)
    for m, k, n, logits in SCHEDULE_SHAPES:
        flat = check_schedules(gen, m, k, n, logits=logits)
        for kname, rec in flat.items():
            summary.setdefault(kname, rec)  # the first shape: decode q/k/v
    family_gen = torch.Generator(device="cuda").manual_seed(8)
    for label, kw in DECODE_ROWS:
        g = family_gen if label in FAMILY_PAGED else gen
        summary.setdefault("paged_attention_decode", check_decode(g, label=label, **kw))
    for label, kw in PREFILL_ROWS:
        g = family_gen if label in FAMILY_PAGED else gen
        summary.setdefault("paged_attention_prefill", check_prefill(g, label=label, **kw))
    grad_launches = check_gradients(gen, summary)
    scan_launches = check_scans(gen, summary)

    cfg = get_config("qwen1.5-0.5b")
    params = lm.init(cfg, seed=0, device="cuda")
    check_model(cfg, params)
    # the speculative slice: qwen1.5-1.8b (untied head, head dim 128) at
    # full width, its draft the qwen1.5-0.5b above (the launcher's seed)
    cfg18 = get_config("qwen1.5-1.8b")
    params18 = lm.init(cfg18, seed=0, device="cuda")
    check_spec_model(cfg18, params18)
    serve_launches = check_serving(cfg, params)
    for run in check_spec_serving(cfg18, params18, draft_for("qwen1.5-1.8b"), cfg, params):
        serve_launches = {k: serve_launches[k] + run[k] for k in kernels.KERNELS}
    check_clean("phases 2-4")
    del params18
    check_reference(cfg, params)
    for run in check_degraded_serving(cfg, params) + [check_serve_loop(cfg, params)]:
        serve_launches = {k: serve_launches[k] + run[k] for k in kernels.KERNELS}

    # phase 6: moonshot-v1-16b-a3b at full width and depth (about 56 GB of
    # bf16 weights), built on the card once every earlier model is freed
    grouped = [check_grouped(gen, *row) for row in GROUPED_ROWS]
    del params
    torch.cuda.empty_cache()
    cfg_moe = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params_moe = lm.init(cfg_moe, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit(dict(check="moe_model", arch=cfg_moe.name, layers=cfg_moe.n_layers,
              depth_cut="none", params=sum(t.numel() for t in _leaves(params_moe)),
              bytes=sum(t.numel() * t.element_size() for t in _leaves(params_moe)),
              init_s=time.perf_counter() - t0,
              memory_allocated_gb=torch.cuda.memory_allocated() / 1e9))
    check_moe_model(cfg_moe, params_moe)
    run = check_moe_serving(cfg_moe, params_moe)
    serve_launches = {k: serve_launches[k] + run[k] for k in kernels.KERNELS}
    check_clean("phase 6")
    del params_moe
    torch.cuda.empty_cache()

    # phase 7: mamba2-780m and recurrentgemma-2b at full width and depth
    run, _ = check_recurrent(gen)
    serve_launches = {k: serve_launches[k] + run[k] for k in kernels.KERNELS}
    check_clean("phase 7")

    # phase 8: whisper-medium, pixtral-12b, gemma2-9b, deepseek-7b and
    # command-r-35b at full width and depth, one at a time
    run = check_families(gen)
    serve_launches = {k: serve_launches[k] + run[k] for k in kernels.KERNELS}
    check_clean("phase 8")

    # phase 9: training on the card
    train_launches = check_training(torch.Generator(device="cuda").manual_seed(9))
    check_clean("phase 9")

    # phase 10: the launchers traced at full width
    trace_launches = check_trace_tooling()
    check_clean("phase 10")
    launches = {k: serve_launches[k] + grad_launches[k] + scan_launches[k] + train_launches[k]
                + trace_launches[k] for k in kernels.KERNELS}

    kernels_line = []
    for kname in kernels.KERNELS:
        rec = summary[kname]
        source, replaces = KERNEL_META[kname]
        kernels_line.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname], max_abs_err=rec["max_err"], ms=rec["kernel_ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"]))
        if kname in grouped[0]:  # the grouped form (the MoE experts), phase 6's first row
            g = grouped[0][kname]
            kernels_line[-1]["grouped"] = dict(
                row=g["row"], shape=g["shape"], design=g["design"], max_abs_err=g["max_err"],
                ms=g["kernel_ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
                bound_by=g["bound_by"], library_ms=g["library_ms"])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
