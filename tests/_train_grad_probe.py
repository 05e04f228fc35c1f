"""The train-step gradient gate of ``chip_smoke.py``'s phase 9
(``check_train_step``: each leaf within ``GRAD_REL`` or the flipped-ulp
witness) on more draws, and against planted kernel faults.

    python3 tests/_train_grad_probe.py

from the repository root on a machine with one CUDA card (about 3 min).

* Draws: qwen1.5-0.5b at full width and depth and moonshot-v1-16b-a3b
  cut to phase 9's 2 layers, batch 8 x seq 128, under the default
  policy, for each (init seed, data seed) of ``DRAWS``: the worst leaf's
  relative L2 gap between the kernel and plain runs, its witness, the
  largest gap over its witness, and the leaves that pass only through
  the witness (gap above ``GRAD_REL``), and the leaves that fail it.
* Faults, on the first draw: the kernel run again with the matmul
  wrappers wrapped (the repository's code unchanged) so that a launch
  skips its last 64-wide block of the contracted axis, as a K-tile loop
  that stops one tile short would (``tests/_matmul_faults.py`` plants
  that fault in the CUDA source): in every launch, in the weight
  gradients' launches only (their A operand is not K-major: ``A^T``),
  and in one launch, the middle weight-gradient launch.  For each: the
  leaves the gate fails, out of all, and the smallest gap over the
  gate's allowance (max(``GRAD_REL``, witness)) among the leaves the
  fault reaches (those whose gradient differs from the unfaulted kernel
  run's).

It prints one JSON line per draw and per fault and exits 0 (a probe: it
gates nothing).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DRAWS = ((0, 0), (0, 1), (1, 0), (2, 2), (3, 3))  # (init seed, data seed); (0, 0) is phase 9's
SHORT = 64  # the skipped block of the contracted axis


def setup(arch: str, layers: int | None, init_seed: int, data_seed: int):
    cfg = cs.get_config(arch)
    if layers is not None:
        cfg = cs.cut_depth(cfg, {"layers": []}, layers)[0]
    params = cs.lm.init(cfg, seed=init_seed, device="cuda")
    batch = cs.data_batch(cs.DataConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_SEQ,
                                        global_batch=cs.TRAIN_BATCH, seed=data_seed), 0, "cuda")
    bundle = cs.build_train_step(cfg, cs.ShapeCfg("probe", "train", cs.TRAIN_SEQ,
                                                  cs.TRAIN_BATCH), loss_chunk=None)
    return cfg, params, batch, bundle


def faulty(pick):
    """Patch the kernel layer's three matmul wrappers: the launch numbered
    ``i`` (in call order) with first operand ``a`` gets ``a``'s last
    ``SHORT`` contracted columns zeroed where ``pick(i, a)``."""
    seen = [0]

    def wrap(name):
        fn = cs.kernels.KERNELS[name]

        def run(a, b, *rest, **kw):
            i, seen[0] = seen[0], seen[0] + 1
            if pick(i, a):
                a = a.clone()  # keeps a's strides
                a[..., -SHORT:] = 0
            return fn(a, b, *rest, **kw)
        return run

    return mock.patch.multiple(cs.api, **{n: wrap(n) for n in cs._PLAIN})


def summary(rows) -> dict:
    worst = max(rows)
    return dict(leaves=len(rows), worst_rel_l2=worst[0], worst_leaf=worst[1],
                worst_leaf_witness=worst[2],
                worst_over_witness=max(r[0] / max(r[2], 1e-30) for r in rows),
                worst_witness=max(r[2] for r in rows),
                passing_only_by_witness=sum(cs.GRAD_REL < r[0] <= r[2] for r in rows),
                failing=[dict(leaf=r[1], rel_l2=r[0], witness_rel_l2=r[2])
                         for r in rows if not cs.leaf_passes(r[0], r[2])])


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs._build.build_all()
    for arch, layers in ((cs.TRAIN_ARCH, None), (cs.MOE_ARCH, cs.MOE_TRAIN_LAYERS)):
        for n, (init_seed, data_seed) in enumerate(DRAWS):
            cfg, params, batch, bundle = setup(arch, layers, init_seed, data_seed)
            calls = []
            with cs.noting_matmuls(calls):
                _, grads = cs.value_and_grad(bundle.loss_of, params, batch)
            (_, plain), (_, witness) = cs.plain_and_witness(bundle, params, batch)
            print(json.dumps(dict(probe="draw", arch=arch, layers=cfg.n_layers,
                                  init_seed=init_seed, data_seed=data_seed,
                                  **summary(cs.leaf_gaps(params, grads, plain, witness)))),
                  flush=True)
            if n == 0:
                weight_grads = [i for i, c in enumerate(calls) if c[1][0].stride(-1) != 1]
                middle = weight_grads[len(weight_grads) // 2]
                for fault, pick in (
                        ("every launch", lambda i, a: True),
                        ("weight-gradient launches", lambda i, a: a.stride(-1) != 1),
                        (f"one launch (call {middle}, shape {list(calls[middle][1][0].shape)}"
                         f" x {list(calls[middle][1][1].shape)})", lambda i, a: i == middle)):
                    with faulty(pick):
                        _, bad = cs.value_and_grad(bundle.loss_of, params, batch)
                    rows = cs.leaf_gaps(params, bad, plain, witness)
                    reached = [r for r, g, b in zip(rows, cs._leaves(grads), cs._leaves(bad))
                               if not torch.equal(g, b)]
                    print(json.dumps(dict(
                        probe="fault", arch=arch, fault=fault, short=SHORT,
                        leaves=len(rows), leaves_reached=len(reached),
                        leaves_failing=sum(not cs.leaf_passes(r[0], r[2]) for r in rows),
                        least_gap_over_allowance=min(
                            (r[0] / max(cs.GRAD_REL, r[2]) for r in reached), default=None),
                        caught=any(not cs.leaf_passes(r[0], r[2]) for r in rows))), flush=True)
                    del bad
            del params, grads, plain, witness
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
