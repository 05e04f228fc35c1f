"""Radix-tree prefix cache: token prefixes -> shared page chains.

A prefilled prefix is "multicast" to later requests the way the paper's
crossbar multicasts an operand: the KV pages covering it are computed
and stored **once**, and every request whose prompt starts with the same
tokens gets the same page ids with one refcount bump per consumer
(:class:`~repro_torch.serve.pagepool.PagePool` is the fanout mask).  A
cache-hit prefill then runs the model only over the divergent suffix.

Structure: one tree node per **page** (``page_size`` tokens); a node's
edge key is the exact token tuple its page covers, so lookup is an
O(pages) dict walk and two prompts share a chain iff they share full
pages.  Page granularity (vs. per-token radix splits) keeps the tree in
lockstep with the pool — a node *is* a page, so sharing, refcounts and
eviction all operate on the same unit the device kernels index by.

The tree holds **one reference of its own** on every cached page, so a
chain outlives the request that built it.  Eviction is LRU over leaf
nodes whose page the tree is the *last* holder of (pool refcount 1):
releasing an interior node would orphan its descendants, and releasing
a page some request still reads would corrupt it — both are excluded
structurally.

Matching is capped at ``(len(tokens) - 1) // page_size`` pages: the page
containing a prompt's final token is never shared even when the prompt
length is page-aligned, so every admission prefills at least one token
(the model must produce last-token logits) and the decode-written page
is never a tree page.

**Sharded pools**: with the pool partitioned over a mesh, one
logical page may exist as a physical copy on several shards — a node
keeps ``pages: {shard: page_id}``.  A consumer on shard *t* matches only
*t*-local copies (:meth:`match` ``shard=``); when the chain continues on
other shards, :meth:`remote_continuation` names the source copies and,
after the engine broadcasts the device bytes (one collective per chain —
the crossbar multicast at pod scale), :meth:`commit_broadcast` registers
the new *t*-copies so every later shard-*t* consumer hits locally.  Each
per-shard copy is refcounted and evicted independently; the invariant
that a node's copy on shard *t* implies its parent has one too
(prefix-closedness per shard) keeps local matches contiguous.  With one
shard, every structure and code path below reduces exactly to the
single-shard tree.
"""
from __future__ import annotations

import heapq
from typing import Iterable, Sequence

from repro_torch.obs import trace
from repro_torch.serve.pagepool import PagePool


class _Node:
    __slots__ = ("key", "pages", "parent", "children", "tick")

    def __init__(self, key, parent):
        self.key = key  # token tuple covering this page (() for the root)
        self.pages: dict[int, int] = {}  # shard -> pool page id of its copy
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.tick = 0  # last-touched counter for LRU

    @property
    def page_id(self):
        """The primary (first-registered) copy's page id — the
        single-copy view; ``None`` for the root."""
        return next(iter(self.pages.values()), None)


class PrefixCache:
    def __init__(self, pool: PagePool, page_size: int | None = None):
        self.pool = pool
        self.page_size = int(page_size or pool.page_size)
        self.root = _Node((), None)
        self._tick = 0
        self.hit_tokens = 0  # prefill tokens skipped via matches
        self.miss_tokens = 0  # prefill tokens actually computed

    # ------------------------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        # refresh the whole chain: an interior page is at least as
        # recently useful as the deepest leaf that just used it
        while node is not self.root:
            node.tick = self._tick
            node = node.parent

    def _pages(self, tokens: Sequence[int], n_pages: int) -> Iterable[tuple]:
        ps = self.page_size
        for i in range(n_pages):
            yield tuple(tokens[i * ps : (i + 1) * ps])

    def _walk(self, tokens: Sequence[int]) -> Iterable[_Node]:
        """The cached node chain covering ``tokens``'s shareable pages
        (stops at the first uncached page; never yields the last-token
        page)."""
        cap = max(0, (len(tokens) - 1) // self.page_size)
        node = self.root
        for key in self._pages(tokens, cap):
            child = node.children.get(key)
            if child is None:
                return
            yield child
            node = child

    # ------------------------------------------------------------------
    def match(self, tokens: Sequence[int], shard: int = 0) -> tuple[list[int], int]:
        """Longest cached page chain covering a proper prefix of
        ``tokens`` with a copy **local to** ``shard``.  Returns
        ``(page_ids, n_matched_tokens)`` and takes **one reference per
        matched page for the caller** (release them via the pool when
        the request retires or admission aborts).  Per-shard
        prefix-closedness makes the local run contiguous, so stopping at
        the first node without a ``shard`` copy loses nothing."""
        out, last = [], None
        for child in self._walk(tokens):
            pid = child.pages.get(shard)
            if pid is None:
                break
            out.append(pid)
            last = child
        if out:
            self._touch(last)
            self.pool.share(out)
        matched = len(out) * self.page_size
        self.hit_tokens += matched
        self.miss_tokens += len(tokens) - matched
        rec = trace.active()
        if rec is not None:
            rec.instant("prefix.match", cat="prefix",
                        args={"pages": len(out), "hit_tokens": matched,
                              "miss_tokens": len(tokens) - matched,
                              "shard": shard})
        return out, matched

    def unmatch(self, page_ids: list[int], n_tokens: int) -> None:
        """Abort path of :meth:`match` (admission rejected): release the
        caller refs *and* reverse the hit/share accounting, so a request
        that waits in the queue and re-probes every scheduling round
        doesn't inflate the multicast stats while receiving nothing."""
        self.pool.release(page_ids)
        self.pool.stats.shared -= len(page_ids)
        matched = len(page_ids) * self.page_size
        self.hit_tokens -= matched
        self.miss_tokens -= n_tokens - matched
        rec = trace.active()
        if rec is not None:
            rec.instant("prefix.unmatch", cat="prefix",
                        args={"pages": len(page_ids), "hit_tokens": matched,
                              "miss_tokens": n_tokens - matched})

    # ------------------------------------------------------------------
    def remote_continuation(
        self, tokens: Sequence[int], shard: int, n_local: int
    ) -> list[tuple[_Node, int]]:
        """The cached chain continuing past ``shard``'s local run of
        ``n_local`` pages: ``[(node, source_page_id), ...]`` where each
        source id is an existing copy on some other shard.  Takes **no**
        references — the caller decides whether to broadcast (alloc
        local pages, copy device bytes cross-shard, then
        :meth:`commit_broadcast`) or re-prefill cold."""
        out = []
        for i, child in enumerate(self._walk(tokens)):
            if i >= n_local:
                out.append((child, next(iter(child.pages.values()))))
        return out

    def commit_broadcast(
        self, nodes: Sequence[_Node], shard: int, new_pids: Sequence[int]
    ) -> None:
        """Register freshly broadcast copies: ``new_pids[i]`` (allocated
        on ``shard``; device bytes already copied from the source) become
        the nodes' ``shard``-local copies.  The tree takes its own
        reference on each — the caller's alloc reference is the consumer
        ref, exactly as if :meth:`match` had hit locally.  The tokens the
        broadcast covers move from the miss to the hit column: they were
        **not** re-prefilled, they crossed the fabric once."""
        for node, pid in zip(nodes, new_pids):
            node.pages[shard] = pid
            self.pool.share([pid])  # the tree's own reference on the copy
        if nodes:
            self._touch(nodes[-1])
            bp = len(nodes) * self.page_size
            self.hit_tokens += bp
            self.miss_tokens -= bp
            rec = trace.active()
            if rec is not None:
                rec.instant("prefix.commit_broadcast", cat="prefix",
                            args={"pages": len(nodes), "tokens": bp,
                                  "shard": shard})

    # ------------------------------------------------------------------
    def insert(
        self, tokens: Sequence[int], page_ids: Sequence[int], shard: int = 0
    ) -> int:
        """Register the full pages of a prefilled prompt (``page_ids[i]``
        holds tokens ``[i*ps, (i+1)*ps)``, resident on ``shard``).  The
        tree takes one reference of its own per newly cached copy; pages
        already cached on ``shard`` keep the existing copy (first writer
        wins — both copies are identical by construction).  Returns the
        number of copies newly inserted."""
        node, new = self.root, 0
        for i, key in enumerate(self._pages(tokens, len(tokens) // self.page_size)):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, node)
                node.children[key] = child
            if shard not in child.pages:
                self.pool.share([page_ids[i]])  # the tree's own reference
                child.pages[shard] = page_ids[i]
                new += 1
            node = child
        if node is not self.root:
            self._touch(node)
        if new:
            rec = trace.active()
            if rec is not None:
                rec.instant("prefix.insert", cat="prefix",
                            args={"pages": new, "shard": shard})
        return new

    # ------------------------------------------------------------------
    def _nodes(self) -> list[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.extend(n.children.values())
            stack.extend(n.children.values())
        return out

    def __len__(self) -> int:
        """Number of cached logical pages (tree nodes)."""
        return len(self._nodes())

    def pages(self) -> list[int]:
        """Page ids the tree holds a reference on (one per copy) — the
        tree's contribution to the pool auditor's refcount cross-count
        (``PagePool.check(holders=...)``)."""
        return [pid for n in self._nodes() for pid in n.pages.values()]

    def drop(self, page_ids: Iterable[int]) -> list[int]:
        """Quarantine: remove every subtree rooted at a node holding one
        of ``page_ids`` (as *any* shard's copy) and release the tree's
        own reference on each removed copy.  Descendants go too — a
        chain below a corrupted page was prefilled *against* those
        bytes, so its K/V is poisoned even if its own pages read back
        clean; sibling-shard copies of a dropped node go too, because a
        broadcast clones bytes and therefore clones corruption.  Returns
        the page ids whose tree reference was released (pages still
        shared with running requests stay alive until those release; the
        tree just stops multicasting them to new consumers)."""
        bad = set(page_ids)
        dropped: list[int] = []

        def walk(node: _Node) -> None:
            for key, child in list(node.children.items()):
                if bad & set(child.pages.values()):
                    del node.children[key]
                    for n in self._subtree(child):
                        for pid in n.pages.values():
                            self.pool.release([pid])
                            dropped.append(pid)
                else:
                    walk(child)

        walk(self.root)
        return dropped

    def _subtree(self, node: _Node) -> list[_Node]:
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    # ------------------------------------------------------------------
    def _evictable(self, node: _Node, shard: int) -> bool:
        """May ``node``'s ``shard``-copy be released right now?  Only if
        the tree is its last holder, no child still has a ``shard`` copy
        (per-shard prefix-closedness), and it isn't the last copy of an
        interior node (which would orphan the walk to its descendants)."""
        pid = node.pages.get(shard)
        if pid is None or self.pool.refcount(pid) != 1:
            return False
        if any(shard in c.pages for c in node.children.values()):
            return False
        if len(node.pages) == 1 and node.children:
            return False
        return True

    def evictable_pages(self, shard: int | None = None) -> int:
        """How many page copies :meth:`evict` could free right now: the
        union of fully refcount-1 subtrees (a refcount-1 node pinned by
        a shared descendant is structurally unevictable), counting only
        ``shard``'s copies when given.  Lets callers test feasibility
        *before* destroying cached chains."""
        def walk(node: _Node) -> tuple[int, bool, bool]:
            # (freeable copies, subtree fully evictable, node survives)
            cnt, full, surv = 0, True, False
            for child in node.children.values():
                c_cnt, c_full, c_surv = walk(child)
                cnt += c_cnt
                full = full and c_full
                surv = surv or c_surv
            if node is self.root:
                return cnt, False, True
            rel = [p for s, p in node.pages.items()
                   if shard is None or s == shard]
            if not rel:
                return cnt, full, True
            others = len(node.pages) - len(rel)
            if (full and all(self.pool.refcount(p) == 1 for p in rel)
                    and (others > 0 or not surv)):
                return cnt + len(rel), True, others > 0
            return cnt, False, True

        return walk(self.root)[0]

    def evict(self, n_pages: int, shard: int | None = None) -> int:
        """Release up to ``n_pages`` LRU refcount-1 page copies back to
        the pool (leaf-first, cascading to parents as they become
        evictable), restricted to ``shard``'s copies when given (the
        per-shard watermark reclaims capacity *where the admission needs
        it*).  Returns how many copies were actually freed.

        One tree walk seeds an LRU heap of evictable (node, shard)
        copies; a removed copy's parent joins the heap incrementally —
        the whole call is O(tree + freed·log tree), and it sits on the
        admission / decode-page-fault path."""
        heap = [
            (n.tick, id(n), s, n) for n in self._nodes()
            for s in n.pages
            if (shard is None or s == shard) and self._evictable(n, s)
        ]
        heapq.heapify(heap)
        freed = 0
        while freed < n_pages and heap:
            _, _, s, victim = heapq.heappop(heap)
            if not self._evictable(victim, s):
                continue  # stale entry (copy already gone via cascade)
            self.pool.release([victim.pages.pop(s)])
            freed += 1
            parent = victim.parent
            removed = not victim.pages
            if removed:
                del parent.children[victim.key]
            if parent is self.root:
                continue
            for s2 in (parent.pages if removed else (s,)):
                if ((shard is None or s2 == shard)
                        and self._evictable(parent, s2)):
                    heapq.heappush(heap, (parent.tick, id(parent), s2, parent))
        if freed:
            rec = trace.active()
            if rec is not None:
                rec.instant("prefix.evict", cat="prefix",
                            args={"pages": freed,
                                  "shard": -1 if shard is None else shard})
        return freed
