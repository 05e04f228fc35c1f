"""Refcounted page pool — the serving-side multicast fabric.

The paper's crossbar fetches a shared operand once and delivers it to N
consumers; the serving equivalent is a KV-cache *page* written once and
referenced by every request that shares the prefix it covers.  This
module is the host-side allocator for those pages: a fixed pool of
page-granular KV blocks with

* **free-list allocation** (O(1) alloc/free, all-or-nothing grants so a
  half-admitted request can never wedge the pool),
* **refcounting** (a page is "multicast" to N requests by incrementing
  its refcount N times — the fanout mask of the analogy; the physical
  KV bytes exist once), and
* **copy-on-write** (:meth:`cow`): a writer that does not own a page
  exclusively gets a fresh page id and the caller copies the device
  bytes — divergence after a shared prefix never corrupts the other
  readers.

The pool manages *ids only*; the KV bytes live in the device-side page
arrays (``nn.attention.PagedKvCache``), indexed by these ids.  One id
addresses the same physical page index in **every** layer's pool (the
standard block-table design), so allocation happens once per page, not
once per layer.

Page ``0`` is reserved as the **null page**: the device write path
redirects out-of-range / padded-position writes there, so it is never
granted to a request and its contents are garbage by design.

**Mesh sharding** (``num_shards > 1``): the non-null pages are
partitioned into ``num_shards`` equal contiguous ranges — shard ``s``
owns global ids ``[1 + s*pps, 1 + (s+1)*pps)`` — each with its own free
list, so a block table's global page id *is* the ``(shard, local_page)``
pair: ``shard_of(pid) = (pid-1) // pps``, ``local_page(pid) =
(pid-1) % pps``.  Device page arrays are sharded over the mesh along
the page axis with exactly this split, so a page allocated from shard
``s``'s free list physically lives on device ``s``.  Refcounts stay one
flat host-side array (the fanout mask is global — a broadcast copy on
another shard is a *different page id* with its own refcount).  With
``num_shards=1`` every code path degenerates to the single-shard pool
bit-for-bit: one free list, same grant order, same stats.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Sequence

from repro_torch.obs import trace
from repro_torch.serve import faults

NULL_PAGE = 0


@dataclasses.dataclass
class PoolStats:
    """Cumulative counters + high-water mark.  ``shared`` counts
    *committed* multicast fanout: a rejected admission's probe is
    reversed by ``PrefixCache.unmatch``."""

    allocated: int = 0  # pages granted by alloc()
    shared: int = 0  # refcount increments via share() (multicast fanout)
    freed: int = 0  # pages returned to the free list
    cow_copies: int = 0  # copy-on-write page duplications
    peak_in_use: int = 0


class PagePool:
    """Fixed pool of ``num_pages`` page ids, each covering ``page_size``
    token positions in every layer's device page array, partitioned into
    ``num_shards`` equal per-shard free lists (default 1)."""

    def __init__(self, num_pages: int, page_size: int, *, num_shards: int = 1):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        if num_shards < 1:
            raise ValueError("num_shards must be positive")
        if (num_pages - 1) % num_shards:
            raise ValueError(
                f"num_pages-1 ({num_pages - 1}) must divide evenly over "
                f"num_shards={num_shards} (equal per-shard page ranges)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_shards = int(num_shards)
        self.pages_per_shard = (self.num_pages - 1) // self.num_shards
        self._ref = [0] * self.num_pages
        self._free: list[deque[int]] = [
            deque(range(1 + s * self.pages_per_shard,
                        1 + (s + 1) * self.pages_per_shard))
            for s in range(self.num_shards)
        ]
        self.stats = PoolStats()

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def in_use(self) -> int:
        """Pages currently referenced (excludes the null page)."""
        return self.num_pages - 1 - self.free_pages

    def free_pages_on(self, shard: int) -> int:
        return len(self._free[shard])

    def free_ids(self) -> list[int]:
        """All free page ids, across every shard (audit surface)."""
        return [pid for f in self._free for pid in f]

    def shard_of(self, page_id: int) -> int:
        """The shard owning ``page_id`` — the host half of the
        ``(shard, local_page)`` block-table mapping."""
        if page_id == NULL_PAGE:
            raise ValueError("the null page belongs to no shard")
        return (page_id - 1) // self.pages_per_shard

    def local_page(self, page_id: int) -> int:
        """``page_id``'s index within its owning shard's range."""
        if page_id == NULL_PAGE:
            raise ValueError("the null page belongs to no shard")
        return (page_id - 1) % self.pages_per_shard

    def refcount(self, page_id: int) -> int:
        return self._ref[page_id]

    # ------------------------------------------------------------------
    def alloc(self, n: int, shard: int = 0) -> list[int] | None:
        """Grant ``n`` fresh pages from ``shard``'s free list (refcount 1
        each), or ``None`` if that shard cannot satisfy the whole
        request (all-or-nothing)."""
        if n < 0:
            raise ValueError(n)
        free = self._free[shard]
        if n > len(free):
            return None
        if n and faults.fires("pool.alloc") is not None:
            return None  # injected exhaustion: same signal as a dry pool
        ids = [free.popleft() for _ in range(n)]
        for pid in ids:
            self._ref[pid] = 1
        self.stats.allocated += n
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        rec = trace.active()
        if rec is not None and n:
            rec.instant("pool.alloc", cat="pool", args={"n": n, "shard": shard})
        return ids

    def share(self, page_ids: list[int]) -> None:
        """Add one reference per page — the multicast fanout increment."""
        for pid in page_ids:
            if self._ref[pid] <= 0:
                raise ValueError(f"share of unreferenced page {pid}")
            self._ref[pid] += 1
        self.stats.shared += len(page_ids)
        rec = trace.active()
        if rec is not None and page_ids:
            rec.instant("pool.share", cat="pool", args={"n": len(page_ids)})

    def release(self, page_ids: list[int]) -> list[int]:
        """Drop one reference per page; returns the ids that hit
        refcount 0 and went back on their owning shard's free list."""
        freed = []
        for pid in page_ids:
            if pid == NULL_PAGE:
                raise ValueError("release of the null page")
            if self._ref[pid] <= 0:
                raise ValueError(f"release of unreferenced page {pid}")
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                self._free[self.shard_of(pid)].append(pid)
                freed.append(pid)
        self.stats.freed += len(freed)
        rec = trace.active()
        if rec is not None and page_ids:
            rec.instant("pool.release", cat="pool",
                        args={"n": len(page_ids), "freed": len(freed)})
        return freed

    def cow(self, page_id: int, shard: int | None = None) -> tuple[int, bool] | None:
        """Copy-on-write: make ``page_id`` exclusively owned by the caller.

        Returns ``(page_id, False)`` when the caller already owns it
        exclusively (refcount 1 — no copy needed), ``(new_id, True)``
        when the page was shared (the caller must copy the device bytes
        ``new_id <- page_id`` and use ``new_id`` from now on; the old
        reference is released), or ``None`` when the pool is dry.

        ``shard`` places the private copy (a cross-shard COW is how a
        forked request diverging on another shard localises its writes);
        the default keeps the copy on ``page_id``'s own shard."""
        if self._ref[page_id] <= 0:
            raise ValueError(f"cow of unreferenced page {page_id}")
        if self._ref[page_id] == 1:
            return page_id, False
        if faults.fires("pool.cow") is not None:
            return None  # injected COW failure: same signal as a dry pool
        granted = self.alloc(1, self.shard_of(page_id) if shard is None else shard)
        if granted is None:
            return None
        self.release([page_id])
        self.stats.cow_copies += 1
        rec = trace.active()
        if rec is not None:
            rec.instant("pool.cow", cat="pool",
                        args={"page": page_id, "new_page": granted[0],
                              "shard": self.shard_of(granted[0])})
        return granted[0], True

    # ------------------------------------------------------------------
    def check(self, holders: Iterable[Sequence[int]] | None = None) -> None:
        """Audit the pool's invariants (free-list disjointness, per-shard
        containment, refcount vs. free-list consistency, null-page
        sanity) and — given ``holders``, the live page-id chains (running
        slots, prefix-tree nodes, in-flight match refs) — an exact
        refcount cross-count.  Raises
        :class:`repro_torch.serve.guard.GuardViolation` on the first violated
        invariant; see :mod:`repro_torch.serve.guard`."""
        from repro_torch.serve.guard import check_pool  # pagepool is imported first

        check_pool(self, holders)
