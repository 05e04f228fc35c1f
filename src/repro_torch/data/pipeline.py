"""Deterministic synthetic data: the port of the JAX package's
``data/pipeline.py``.

Every (step, row range) is a pure function of the seed, so a restart
resumes bit-identically from the checkpointed step.  The numpy generator
is copied from the JAX package (``_tokens_for``), so the port's batches
are bit-equal to JAX's ``global_batch_np``.  The token stream stitches
together 16-token motifs drawn from a fixed per-seed bank, so the next
token is learnable.  :func:`batch` puts the whole batch on one device;
:func:`sharded_batch` puts a rank's rows of it on that rank's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DEFAULT, resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 64  # learnable structure: repeated n-gram patterns


def _tokens_for(cfg: DataConfig, step: int, start_row: int, n_rows: int) -> np.ndarray:
    """Deterministic (step, row-range) -> int32 tokens (n_rows, seq+1)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, start_row, n_rows])
    )
    bank_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 7]))
    bank = bank_rng.integers(0, cfg.vocab, size=(cfg.n_patterns, 16), dtype=np.int64)
    n_motifs = (cfg.seq_len + 1 + 15) // 16
    idx = rng.integers(0, cfg.n_patterns, size=(n_rows, n_motifs))
    rows = bank[idx].reshape(n_rows, -1)[:, : cfg.seq_len + 1]
    return rows.astype(np.int32)


def global_batch_np(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    toks = _tokens_for(cfg, step, 0, cfg.global_batch)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch(cfg: DataConfig, step: int, device: str | torch.device = DEFAULT
          ) -> dict[str, torch.Tensor]:
    """The step's whole batch as int32 ``tokens`` / ``labels`` tensors
    (global_batch, seq_len) on ``device``."""
    dev = resolve(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in global_batch_np(cfg, step).items()}


def shard_rows(global_batch: int, mesh, batch_axes) -> tuple[int, int]:
    """(first row, row count) of this rank's block of the global batch:
    ``P(batch_axes, None)``'s row split, the first axis major."""
    n = mesh.size(batch_axes) if batch_axes else 1
    if global_batch % n:
        raise ValueError(f"{global_batch} rows do not split over {n} ranks")
    rows = global_batch // n
    return (mesh.index(batch_axes) if batch_axes else 0) * rows, rows


def sharded_batch(cfg: DataConfig, step: int, mesh, batch_axes,
                  device: str | torch.device = DEFAULT) -> dict[str, torch.Tensor]:
    """This rank's rows of the step's batch on ``device`` (``mesh`` a bound
    mesh; ranks along axes outside ``batch_axes`` get the same rows): the
    union over the ranks is ``global_batch_np`` bit for bit, so a sharded
    step sees the one-device step's data.

    The rows are cut from ``_tokens_for(cfg, step, 0, global_batch)`` on
    the host (int32 tokens: a few MB at any configuration).  The JAX
    package's ``sharded_batch`` instead draws each shard from its own
    ``(start_row, n_rows)`` seed, so its batches on more than one device
    are other tokens than its one-device batch."""
    start, n = shard_rows(cfg.global_batch, mesh, batch_axes)
    t = _tokens_for(cfg, step, 0, cfg.global_batch)[start:start + n]
    dev = resolve(device)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(t[:, :-1])).to(dev),
            "labels": torch.from_numpy(np.ascontiguousarray(t[:, 1:])).to(dev)}
