"""Continuous-batching scheduler policy (host-side, pure decisions).

Separates the *policy* — who gets admitted, who gets preempted, when
cached prefixes get evicted — from the *mechanism* (device writes,
page bookkeeping) in :mod:`repro_torch.serve.engine`:

* **Admission by free-page watermark**: a queued request is admitted
  only if its new-page demand leaves at least ``watermark`` pages free.
  The watermark is headroom for the *running* batch's decode growth, so
  admitting a long prompt can't starve next step's decode — decode
  priority expressed as a reservation rather than an ordering.
* **Decode-priority reclamation**: when a decode step needs a page and
  the pool is dry, free capacity is taken first from the prefix cache
  (LRU refcount-1 chains — cached but currently unused data), and only
  then from a running request via preemption.
* **Preemption pick**: youngest-admitted request first (LIFO), so the
  requests that have already burned the most decode compute are the
  last to lose their pages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.obs import trace
from repro_torch.serve import faults
from repro_torch.serve.pagepool import PagePool
from repro_torch.serve.prefix import PrefixCache


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Typed admission rejection: *why* the request cannot run now, and
    how many pages must come free before a retry can succeed.

    Falsy on purpose — ``if not engine._admit(req)`` keeps working while
    the caller that cares (``PagedEngine.run``, the chaos suite, an
    upstream admission queue) reads the reason instead of guessing from
    a silently stalled queue head.

    Reasons:

    * ``"no-free-slot"`` — every batch lane is occupied; pages are not
      the constraint (``retry_after_pages == 0``).
    * ``"watermark"``    — the pool could cover the request, but only by
      dipping into the decode-headroom reserve.
    * ``"pool-dry"``     — the pool cannot cover the request even at
      watermark 0 (after any feasible prefix eviction).
    """

    reason: str
    retry_after_pages: int = 0

    def __bool__(self) -> bool:
        return False


@dataclasses.dataclass
class Scheduler:
    pool: PagePool
    prefix: PrefixCache | None = None
    watermark: int = 2  # pages kept free after any admission

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` positions."""
        return math.ceil(n_tokens / self.pool.page_size)

    def pages_for_range(self, covered_tokens: int, end_tokens: int) -> int:
        """Fresh pages a prefill *chunk* ending at ``end_tokens`` needs
        beyond the pages already covering ``covered_tokens`` — the
        per-chunk charge of chunked prefill: admission reserves the full
        demand up front (watermark), but pages are drawn from the free
        list chunk by chunk as the block table grows."""
        return max(0, self.pages_for(end_tokens) - self.pages_for(covered_tokens))

    # ------------------------------------------------------------------
    def _free(self, shard: int | None) -> int:
        """Free pages in the admission's capacity domain: one shard's
        free list when the pool is mesh-sharded and the caller names the
        shard it allocates from, else the whole pool (the single-shard
        degenerate case and the shard-agnostic test surface)."""
        return (self.pool.free_pages if shard is None
                else self.pool.free_pages_on(shard))

    def _evict_for(self, deficit: int, shard: int | None = None) -> bool:
        """Evict cached prefix chains to cover ``deficit`` pages (on
        ``shard`` when given — reclamation must free capacity *where*
        the admission allocates) — but only when eviction can actually
        cover it: a demand that cannot succeed must not destroy the
        prefix cache as a side effect (it would be re-probed every
        scheduling round)."""
        if deficit <= 0:
            return True
        if faults.fires("sched.evict") is not None:
            return False  # injected reclamation failure: nothing evicted
        if self.prefix is None or self.prefix.evictable_pages(shard) < deficit:
            return False
        rec = trace.active()
        if rec is not None:
            rec.instant("sched.evict", cat="sched",
                        args={"deficit": deficit,
                              "shard": -1 if shard is None else shard})
        self.prefix.evict(deficit, shard)
        return True

    def can_admit(self, new_pages: int, shard: int | None = None) -> bool:
        """Watermark admission test (``new_pages`` = pages the request
        needs *beyond* what prefix sharing already covers).  Evicts
        cold prefix chains first if — and only if — that unblocks the
        admission."""
        return self.check_admission(new_pages, shard) is None

    def check_admission(self, new_pages: int,
                        shard: int | None = None) -> Rejected | None:
        """Structured form of :meth:`can_admit`: ``None`` when the
        request fits (cold prefix chains are evicted first if — and only
        if — that unblocks it), else a :class:`Rejected` naming the
        binding constraint.  ``"watermark"`` means the free list could
        cover the demand but the decode-headroom reserve would be
        breached; ``"pool-dry"`` means it could not, even at watermark
        0 — the caller should expect to wait for ``retry_after_pages``
        pages (or escalate to preemption).  With a mesh-sharded pool the
        watermark is **per shard**: the demand, the reserve, and any
        eviction all bind on ``shard``'s free list — one busy shard
        rejecting an admission says nothing about its siblings."""
        deficit = new_pages + self.watermark - self._free(shard)
        self._evict_for(deficit, shard)
        if self._free(shard) - new_pages >= self.watermark:
            return None
        reason = "pool-dry" if new_pages > self._free(shard) else "watermark"
        return Rejected(reason, new_pages + self.watermark - self._free(shard))

    def reclaim(self, n_pages: int, shard: int | None = None) -> bool:
        """Make ``n_pages`` free for a *running* request (decode page
        fault / COW) on ``shard`` when given: prefix eviction only —
        preemption is the caller's escalation.  Returns True when the
        pages are available."""
        self._evict_for(n_pages - self._free(shard), shard)
        return self._free(shard) >= n_pages

    def pick_victim(self, slots_by_admit_order: Sequence[int]) -> int | None:
        """Preemption victim among running slots (admission order,
        oldest first): the youngest loses its pages."""
        return slots_by_admit_order[-1] if slots_by_admit_order else None
