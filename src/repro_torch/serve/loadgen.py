"""Seeded Poisson load generator for the serving loop.

Produces a **trace**: a list of :class:`Arrival` records — arrival time,
prompt, decode budget — drawn from one seeded generator, so any load run
(benchmark, CI smoke, chaos leg) is exactly reproducible from its seed
and the same trace can be replayed through both the asynchronous
:class:`~repro_torch.serve.server.ServeLoop` and the synchronous turn-by-turn
driver (``PagedEngine.run``) for token-identity checks.  The draws are
the JAX package's, from the same numpy generator, so one seed gives the
same trace in both packages.

Traffic shape knobs (the things Musavi et al. show dominate accelerator
communication at scale — burstiness, fan-out, phase overlap):

* ``qps`` — mean arrival rate; inter-arrival gaps are exponential
  (Poisson process), so bursts and lulls both occur.
* ``shared_prefix_len`` / ``shared_frac`` — a fraction of requests opens
  with one common prefix (system-prompt traffic): the multicast fan-out
  knob.  The prefix is drawn once per generator, from the same seed.
* ``prompt_len`` / ``max_new`` — per-request length mix (inclusive
  ranges or fixed ints).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of a trace.  ``t`` is seconds from trace start."""

    t: float
    rid: int
    prompt: tuple[int, ...]
    max_new: int
    shared: bool  # opens with the generator's common prefix


def _range(spec) -> tuple[int, int]:
    """Accept ``n`` or ``(lo, hi)`` (inclusive)."""
    if isinstance(spec, int):
        return spec, spec
    lo, hi = spec
    if lo > hi or lo < 1:
        raise ValueError(f"bad range spec {spec!r}")
    return lo, hi


class LoadGen:
    """Deterministic Poisson request generator.

    ``trace()`` materialises the full run up front — arrival times are
    part of the workload definition, not of its execution, which is what
    lets the sync oracle replay the identical request sequence with no
    clock at all.
    """

    def __init__(self, *, seed: int, qps: float, duration: float, vocab: int,
                 prompt_len=(4, 12), max_new=8,
                 shared_prefix_len: int = 0, shared_frac: float = 0.5):
        if qps <= 0 or duration <= 0:
            raise ValueError("qps and duration must be positive")
        if not 0.0 <= shared_frac <= 1.0:
            raise ValueError("shared_frac must be in [0, 1]")
        self.seed = seed
        self.qps = qps
        self.duration = duration
        self.vocab = vocab
        self.prompt_len = _range(prompt_len)
        self.max_new = _range(max_new)
        self.shared_prefix_len = shared_prefix_len
        self.shared_frac = shared_frac if shared_prefix_len else 0.0
        rng = np.random.default_rng(seed)
        # the common prefix is part of the generator's identity: drawn
        # first, so prompt draws below never perturb it
        self.prefix = tuple(
            int(x) for x in rng.integers(0, vocab, size=shared_prefix_len)
        )
        self._rng = rng

    def trace(self) -> list[Arrival]:
        rng = np.random.default_rng(self._rng.integers(0, 2**63))
        out: list[Arrival] = []
        t = float(rng.exponential(1.0 / self.qps))
        while t < self.duration:
            shared = bool(self.shared_frac) and rng.random() < self.shared_frac
            n = int(rng.integers(self.prompt_len[0], self.prompt_len[1] + 1))
            body = tuple(int(x) for x in rng.integers(0, self.vocab, size=n))
            out.append(Arrival(
                t=t, rid=len(out),
                prompt=(self.prefix + body) if shared else body,
                max_new=int(rng.integers(self.max_new[0], self.max_new[1] + 1)),
                shared=shared,
            ))
            t += float(rng.exponential(1.0 / self.qps))
        if not out:
            # a tiny qps*duration product can draw an empty trace; a load
            # run over zero requests measures nothing — keep one request
            # at t=0 so every seeded run exercises the loop
            n = int(rng.integers(self.prompt_len[0], self.prompt_len[1] + 1))
            out.append(Arrival(
                t=0.0, rid=0,
                prompt=tuple(int(x) for x in rng.integers(0, self.vocab, size=n)),
                max_new=int(rng.integers(self.max_new[0], self.max_new[1] + 1)),
                shared=False,
            ))
        return out
