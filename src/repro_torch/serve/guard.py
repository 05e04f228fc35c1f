"""Invariant auditor + per-page fingerprints for the paged serving stack.

The page pool is the serving stack's multicast fabric: one physical page
fanned out to N consumers by refcount.  That sharing is also the failure
amplifier — a leaked refcount strands capacity forever, a corrupted
shared page poisons every request that matches the prefix covering it.
This module is the detection layer:

* :func:`check_pool` (surfaced as ``PagePool.check()``) — structural
  audit of the pool: free-list disjointness, refcount/free-list
  consistency, null-page-0 sanity, and — given the current *holders*
  (every live page-id chain: running slots, prefix-tree nodes) — an
  exact cross-count of every page's refcount against who actually holds
  it.  A rejected admission, a preemption, a quarantine must all leave
  this audit green.
* :class:`PageFingerprints` — optional (``kv_guard``) content checksums
  of the named pages, keyed by page id.  Recorded when a chain enters the
  prefix tree and verified **at the sharing point** (a prefix hit), so
  corruption of a shared chain is caught before it fans out to a new
  consumer — the engine quarantines that chain instead of letting it
  poison every request that shares the prefix.
* :func:`blob_checksum` — the same tripwire over a preemption swap blob
  on the host, recorded at swap-out and verified before swap-in.

A checksum is the sum of the elements' bit patterns read as integers:
exact, so it is the same on any device, in any reduction order and at
any pool size, but not a cryptographic hash — a tripwire for bit flips
and mis-writes.

**Over a mesh of ranks** (``PagedEngine(mesh=)``) each rank holds only
its shards' pages.  The engine passes ``local=``, which maps a page id to
the page's index on this rank, or to None where another rank holds it:
a rank records and verifies only the pages it holds, so a page's
fingerprint lives on its home rank.  The engine then sums every rank's
bad pages in one all-reduce, and every rank quarantines the same chain.
A swap blob's checksum is taken and checked on the rank holding the
blob, and the engine shares its "lost" verdict the same way.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence

import numpy as np

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


# ---------------------------------------------------------------------------
# per-page content fingerprints
# ---------------------------------------------------------------------------


def _bits(t):
    """``t``'s elements' bit patterns as int64 (any dtype)."""
    import torch

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()]).to(torch.int64)


def page_checksums(caches, ids: Sequence[int]) -> np.ndarray:
    """The checksum of each page ``ids`` (indices into the pool tensors)
    over every pool tensor of every layer (K, V and, in int8 pools, their
    scales): each tensor is (kv_heads, pages, page_size, ·), so every axis
    but 1 is summed.  One host copy."""
    import torch

    first = caches[0][0]
    idx = torch.as_tensor(list(ids), dtype=torch.long, device=first.device)
    total = torch.zeros(len(idx), dtype=torch.int64, device=first.device)
    for layer in caches:
        for t in layer:
            total += _bits(t.index_select(1, idx)).sum(dim=(0, 2, 3))
    return total.cpu().numpy()


class PageFingerprints:
    """Content checksums for pool pages, keyed by page id.

    ``record(caches, page_ids)`` snapshots the named pages' checksums;
    ``verify(caches, page_ids)`` returns the ids whose bytes no longer
    match.  Both read only the named pages — page chains are recorded and
    verified at admission, never inside the decode loop.  ``local`` maps a
    page id to its index in ``caches``, None for a page this process does
    not hold (skipped); by default the id is the index."""

    def __init__(self):
        self._fp: dict[int, int] = {}

    @staticmethod
    def _checksums(caches, page_ids: Sequence[int], local) -> dict[int, int]:
        held = [(int(pid), i) for pid in page_ids
                if (i := (pid if local is None else local(pid))) is not None]
        if not held:
            return {}
        sums = page_checksums(caches, [i for _, i in held])
        return {pid: int(s) for (pid, _), s in zip(held, sums)}

    def record(self, caches, page_ids: Sequence[int], local=None) -> None:
        self._fp.update(self._checksums(caches, page_ids, local))

    def forget(self, page_ids: Sequence[int]) -> None:
        for pid in page_ids:
            self._fp.pop(int(pid), None)

    def verify(self, caches, page_ids: Sequence[int], local=None) -> list[int]:
        """Ids in ``page_ids`` with a recorded fingerprint that no longer
        matches the live bytes (unrecorded pages are skipped — only a
        chain that was fingerprinted can be audited)."""
        got = self._checksums(caches, page_ids, local)
        return [pid for pid, s in got.items() if pid in self._fp and self._fp[pid] != s]


def blob_checksum(data) -> int:
    """Host-side checksum of a preemption swap blob (per layer, a tuple of
    CPU tensors; over a mesh, the packed bytes): recorded at swap-out,
    verified before swap-in scatters the blob back into the pool."""
    if not isinstance(data, (list, tuple)):
        return int(_bits(data).sum())
    return sum(int(_bits(t).sum()) for layer in data for t in layer)
