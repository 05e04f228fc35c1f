"""Deterministic fault injection for the paged serving stack.

The multicast design that makes the serving stack fast is exactly what
makes it fragile: one bad page chain, dry pool, or kernel mis-dispatch
has the blast radius of every request sharing that prefix.  This module
is the adversary — a seedable, deterministic plan of faults that the
pool/scheduler/engine consult at named **injection points**, so chaos
tests can force each failure at an exact allocation/step and assert the
degradation path instead of hoping to hit it.

Design constraints:

* **Zero-cost when inactive.**  Every injection point is a single
  ``faults.fires(site)`` call that returns ``None`` immediately when no
  plan is armed — no plan object, no counters, no rng.  Production code
  never pays for the harness.
* **Deterministic.**  A :class:`Fault` fires on the ``at``-th hit of its
  site (0-based, ``count`` consecutive hits); the optional ``prob`` form
  draws from the plan's seeded generator, so a probabilistic chaos run
  is exactly reproducible from its seed.
* **Scoped.**  :class:`FaultPlan` is a context manager; arming is
  process-global (the engine's jit closures don't thread a plan
  through), and nesting is rejected so a leaked plan can't silently
  corrupt an unrelated test.

Injection sites (each wired into ``pagepool.py``, ``scheduler.py`` or
``engine.py``):

=================  =========================================================
``pool.alloc``     ``PagePool.alloc`` returns ``None`` — forced exhaustion
                   at a chosen allocation.
``pool.cow``       ``PagePool.cow`` fails to grant the private copy.
``sched.evict``    ``Scheduler._evict_for`` refuses to evict — reclamation
                   failure.
``swap.drop``      the preemption swap blob is lost (host data dropped).
``kernel.raise``   the engine's kernel dispatch raises mid-step.
``kernel.nan``     the kernel output is poisoned with NaN (mis-dispatch).
``page.corrupt``   bytes are flipped in a page of the chain a just-admitted
                   request cached (``page_index`` selects which page).
=================  =========================================================
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from repro_torch.obs import trace

SITES = (
    "pool.alloc",
    "pool.cow",
    "sched.evict",
    "swap.drop",
    "kernel.raise",
    "kernel.nan",
    "page.corrupt",
)


class InjectedFault(RuntimeError):
    """Raised by injection points that simulate a hard failure
    (``kernel.raise``); degradation paths catch exactly this plus the
    exceptions a real kernel dispatch can produce."""


@dataclasses.dataclass
class Fault:
    """One planned fault: fire at hit ``at`` of ``site`` (0-based), for
    ``count`` consecutive hits — or, when ``prob`` is set, fire each hit
    with that probability from the plan's seeded rng."""

    site: str
    at: int = 0
    count: int = 1
    prob: float | None = None
    page_index: int = 0  # page.corrupt: index into the just-cached chain

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (have {SITES})")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"need at >= 0, count >= 1: {self}")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1]: {self}")


_ACTIVE: "FaultPlan | None" = None


class FaultPlan:
    """A seedable, armable set of :class:`Fault` entries.

    ``with FaultPlan([Fault("pool.alloc", at=2)]) as plan: ...`` arms the
    plan for the block; injection points inside see it via
    :func:`fires`.  ``plan.fired`` logs every (site, hit index) that
    actually fired, so a test can assert the fault it planned is the
    fault it got."""

    def __init__(self, faults=(), seed: int = 0):
        self.faults = [f if isinstance(f, Fault) else Fault(**f) for f in faults]
        self.rng = np.random.default_rng(seed)
        self.hits: Counter[str] = Counter()
        self.fired: list[tuple[str, int]] = []

    def fires(self, site: str) -> Fault | None:
        """Consume one hit of ``site``; return the fault that fires on
        it, if any (first matching entry wins)."""
        i = self.hits[site]
        self.hits[site] += 1
        for f in self.faults:
            if f.site != site:
                continue
            if f.prob is not None:
                if self.rng.random() < f.prob:
                    self.fired.append((site, i))
                    return f
            elif f.at <= i < f.at + f.count:
                self.fired.append((site, i))
                return f
        return None

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already armed (no nesting)")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


def active() -> FaultPlan | None:
    return _ACTIVE


def fires(site: str) -> Fault | None:
    """The injection point: ``None`` (fast path, no counters touched)
    when no plan is armed, else the armed plan's :meth:`FaultPlan.fires`."""
    if _ACTIVE is None:
        return None
    fault = _ACTIVE.fires(site)
    if fault is not None:
        rec = trace.active()
        if rec is not None:  # chaos runs become visually replayable
            rec.instant(f"fault.{site}", cat="fault",
                        args={"site": site, "hit": _ACTIVE.hits[site] - 1})
    return fault
