"""The sampling decision: one typed interface for every token choice.

The port of the JAX package's ``serve/sampling.py``.  :class:`Sampler`
is the interface the engine asks at admission, at every decode step and
in every speculative verify round, where :meth:`Sampler.verify` composes
over :meth:`Sampler.select`: it keeps the longest prefix of the draft's
proposals that matches what ``select`` chose anyway, which under
:class:`GreedySampler` keeps speculative streams equal to plain greedy
ones.  The old inline form survives as :func:`greedy_token`, which warns
once per call site.
"""
from __future__ import annotations

import sys
import warnings

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

    def verify(self, drafts: np.ndarray, target: np.ndarray) -> np.ndarray:
        """Per-row count of accepted draft tokens.

        ``drafts`` is ``(batch, k)`` proposed ids; ``target`` the
        ``(batch, k+1)`` output of :meth:`select` on the verify step's
        logits (``target[:, i]`` is the token the target wants where draft
        ``i+1`` sits).  Accepted = the length of the leading run where
        ``drafts[:, i] == target[:, i]``."""
        drafts = np.asarray(drafts)
        target = np.asarray(target)
        if target.shape[1] != drafts.shape[1] + 1:
            raise ValueError(
                f"verify: target must score k+1={drafts.shape[1] + 1} "
                f"positions, got {target.shape[1]}")
        match = drafts == target[:, :-1]
        # argmin finds the first False (the first rejection); an all-True
        # row argmins to 0, hence the explicit full-acceptance case
        return np.where(match.all(axis=1), drafts.shape[1],
                        match.argmin(axis=1)).astype(np.int32)


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


# -- legacy shim -------------------------------------------------------

#: (filename, lineno) call sites already warned
_LEGACY_WARNED: set[tuple[str, int]] = set()


def greedy_token(logits: torch.Tensor) -> int:
    """Deprecated: the old inline ``int(argmax(logits[0, -1]))`` admission
    pattern.  Warns once per call site; new code asks a :class:`Sampler`
    (``sampler.select(logits)[0, -1]``)."""
    frame = sys._getframe(1)
    site = (frame.f_code.co_filename, frame.f_lineno)
    if site not in _LEGACY_WARNED:
        _LEGACY_WARNED.add(site)
        warnings.warn(
            "serve.sampling.greedy_token is deprecated; build a Sampler "
            "(serve.sampling.get_sampler) and call sampler.select",
            DeprecationWarning, stacklevel=2)
    return int(GreedySampler().select(logits)[0, -1])
