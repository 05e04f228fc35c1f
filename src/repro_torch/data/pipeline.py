"""Deterministic synthetic data: the port of the JAX package's
``data/pipeline.py``.

Every (step, row range) is a pure function of the seed, so a restart
resumes bit-identically from the checkpointed step.  The numpy generator
is copied from the JAX package (``_tokens_for``), so the port's batches
are bit-equal to JAX's ``global_batch_np``.  The token stream stitches
together 16-token motifs drawn from a fixed per-seed bank, so the next
token is learnable.  The JAX package builds each device's shard of the
batch in place (``sharded_batch``); the port runs on one device, and
:func:`batch` puts the whole batch there.
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
