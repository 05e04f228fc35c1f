"""Invariant auditor for the paged serving stack.

The page pool is the serving stack's multicast fabric: one physical page
fanned out to N consumers by refcount.  That sharing is also the failure
amplifier — a leaked refcount strands capacity forever.
:func:`check_pool` (surfaced as ``PagePool.check()``) is the structural
audit of the pool: free-list disjointness, refcount/free-list
consistency, null-page-0 sanity, and — given the current *holders*
(every live page-id chain: running slots, prefix-tree nodes) — an exact
cross-count of every page's refcount against who actually holds it.  A
rejected admission or a preemption must leave this audit green.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence

NULL_PAGE = 0  # mirrors pagepool.NULL_PAGE (no import: pagepool imports us)


class GuardViolation(AssertionError):
    """An audited invariant does not hold.  Subclasses AssertionError so
    test suites treat it as a failed assertion, with a message naming
    the page and the counts that disagree."""


def check_pool(pool, holders: Iterable[Sequence[int]] | None = None) -> None:
    """Audit ``pool``'s structural invariants; raise :class:`GuardViolation`.

    Always checked:

    * **free-list disjointness** — no duplicate ids on the free list,
      and no free page with a live refcount;
    * **refcount/free-list consistency** — a non-null page has
      refcount 0 iff it sits on the free list (a page in neither place
      is leaked capacity; a page in both is a double grant waiting to
      happen); no negative refcounts;
    * **null-page sanity** — page 0 is never on the free list, never
      refcounted, and the pool's in_use/free accounting adds up.

    With ``holders`` (an iterable of page-id chains — each occurrence of
    a page id in any chain is one expected reference): every page's
    refcount must equal exactly the number of chains holding it — the
    multicast fanout cross-count.
    """
    free = pool.free_ids()
    free_set = set(free)
    if len(free_set) != len(free):
        dupes = [p for p, c in Counter(free).items() if c > 1]
        raise GuardViolation(f"free list holds duplicate page ids: {dupes}")
    for s, shard_free in enumerate(pool._free):
        stray = [pid for pid in shard_free if pool.shard_of(pid) != s]
        if stray:
            raise GuardViolation(
                f"shard {s} free list holds pages owned by another shard: "
                f"{stray} — per-shard containment violated"
            )
    if NULL_PAGE in free_set:
        raise GuardViolation("null page 0 is on the free list")
    if pool._ref[NULL_PAGE] != 0:
        raise GuardViolation(
            f"null page 0 has refcount {pool._ref[NULL_PAGE]} (must stay 0)"
        )
    for pid in range(1, pool.num_pages):
        ref = pool._ref[pid]
        if ref < 0:
            raise GuardViolation(f"page {pid}: negative refcount {ref}")
        if (ref == 0) != (pid in free_set):
            state = "free-listed" if pid in free_set else "leaked (in neither place)"
            raise GuardViolation(
                f"page {pid}: refcount {ref} but {state} — refcount 0 and "
                f"free-list membership must coincide"
            )
    if pool.in_use + pool.free_pages != pool.num_pages - 1:
        raise GuardViolation(
            f"pool accounting: in_use {pool.in_use} + free {pool.free_pages} "
            f"!= {pool.num_pages - 1} usable pages"
        )
    if holders is None:
        return
    expected: Counter[int] = Counter()
    for chain in holders:
        expected.update(chain)
    if expected.get(NULL_PAGE):
        raise GuardViolation("a holder chain references the null page 0")
    for pid in range(1, pool.num_pages):
        if pool._ref[pid] != expected.get(pid, 0):
            raise GuardViolation(
                f"page {pid}: refcount {pool._ref[pid]} != {expected.get(pid, 0)} "
                f"holder references — a reference was leaked or dropped"
            )
