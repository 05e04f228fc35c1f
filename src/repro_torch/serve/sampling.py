"""The sampling decision: one typed interface for every token choice.

The port of the JAX package's ``serve/sampling.py``.  :class:`Sampler`
is the interface the engine asks at admission and at every decode step.
"""
from __future__ import annotations

import numpy as np
import torch

SAMPLERS = ("greedy",)


class Sampler:
    """Chooses the next token at every scored position."""

    #: ServeConfig spelling of this sampler (``get_sampler`` key).
    name: str = "abstract"

    def select(self, logits: torch.Tensor) -> np.ndarray:
        """``(batch, s, vocab)`` logits -> ``(batch, s)`` int32 token ids."""
        raise NotImplementedError


class GreedySampler(Sampler):
    """Deterministic argmax — ties break to the lowest token id."""

    name = "greedy"

    def select(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()


def get_sampler(name: str) -> Sampler:
    """``ServeConfig.sampler`` string -> :class:`Sampler` instance."""
    if name == "greedy":
        return GreedySampler()
    raise ValueError(f"unknown sampler {name!r} (have {SAMPLERS})")
