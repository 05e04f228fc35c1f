"""Deterministic synthetic data: the port of the JAX package's
``data/pipeline.py``.

Every (step, row range) is a pure function of the seed, so a restart
resumes bit-identically from the checkpointed step.  The numpy generator
is copied from the JAX package (``_tokens_for``), so the port's batches
are bit-equal to JAX's ``global_batch_np``.  The token stream stitches
together 16-token motifs drawn from a fixed per-seed bank, so the next
token is learnable.  :func:`batch` puts the whole batch on one device;
:func:`sharded_batch` puts a rank's rows on that rank's device, drawn per
row range as the JAX package's are.
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
    mesh), drawn as the JAX package's ``sharded_batch`` draws each shard:
    ``_tokens_for(cfg, step, start, n)`` for the rank's block ``(start,
    n)`` of ``P(batch_axes, None)`` (ranks along axes outside
    ``batch_axes`` get the same rows; with the batch over no axis of more
    than one rank that is ``global_batch_np``).  The generator is seeded by
    the row range, so on a batch split over several ranks the rows are
    other tokens than the one-device batch's, as in the JAX package; a
    caller that wants the one-device batch cut over ranks slices
    ``global_batch_np`` by :func:`shard_rows` itself."""
    start, n = shard_rows(cfg.global_batch, mesh, batch_axes)
    t = _tokens_for(cfg, step, start, n)
    dev = resolve(device)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(t[:, :-1])).to(dev),
            "labels": torch.from_numpy(np.ascontiguousarray(t[:, 1:])).to(dev)}
