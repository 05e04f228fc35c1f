"""Paged continuous-batching engine: the port of the JAX ``PagedEngine``.

Owns the device side of paged serving and executes the
:class:`~repro_torch.serve.scheduler.Scheduler`'s decisions:

* one **page pool per layer** (``lm.init_paged_cache``), all indexed by
  host-managed block tables (one :class:`PagePool` allocation covers the
  stack);
* **prefix-multicast prefill**: a prompt is matched against the
  :class:`PrefixCache`; matched pages are shared (refcount bump, no
  compute) and only the divergent suffix runs, at its true positions,
  through ``decode_step`` (the chunked-prefill kernel K3).  Cold prompts
  run the dense ``lm.prefill`` and are scattered into pages;
* **chunked prefill** (``prefill_chunk``): a long suffix runs as
  fixed-size chunks, each charged its own pages as the table grows;
* **bucketed prompts**: prompts and suffixes right-pad to shared length
  buckets, with padded positions redirected to the null page;
* **decode page faults**: crossing a page boundary allocates on demand;
  a dry pool first evicts cold prefix chains, then **preempts** the
  youngest request by swapping its pages to host memory (bit-identical
  restore on re-admission);
* **copy-on-write**: a fork shares every page of its parent; the first
  divergent write to a shared page gets a private copy.

The page pools are updated **in place** — the JAX engine returns new
pools from each jitted step and donates the old buffers so XLA may
reuse them; here the tensors are simply written.

Not ported yet (each raises ``NotImplementedError`` naming it): int8 or
fp32 page pools, speculative decoding (``spec_k``), sharded pools
(``num_shards > 1``, a mesh), page fingerprints (``kv_guard``), the
reference-kernel retry (``kernel_fallback``) and fault plans (``chaos``
or an armed :class:`~repro_torch.serve.faults.FaultPlan`).
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter

import numpy as np
import torch

from repro_torch.device import DEFAULT, resolve
from repro_torch.models import lm
from repro_torch.obs import trace
from repro_torch.serve import faults, sampling
from repro_torch.serve.config import ServeConfig, config_from_legacy
from repro_torch.serve.pagepool import PagePool
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import Rejected, Scheduler

# a degraded slot (page fault with nothing left to reclaim) re-enters the
# queue this many times before the request is failed with a typed error
MAX_DEGRADE_REQUEUES = 8


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    # set when the engine permanently fails the request (typed reason)
    error: str | None = None
    # preemption swap state: (host page data, n_pages, length, last_tok)
    _swap: tuple | None = dataclasses.field(default=None, repr=False)
    _requeues: int = dataclasses.field(default=0, repr=False)


def bucket_len(n: int, bucket: int = 16) -> int:
    """Round a prompt/suffix length up to its shared bucket."""
    return max(bucket, math.ceil(n / bucket) * bucket)


def pad_to_bucket(tokens, bucket: int = 16) -> np.ndarray:
    """Right-pad a token list to its length bucket: (1, bucket_len) int32."""
    out = np.zeros((1, bucket_len(len(tokens), bucket)), np.int32)
    out[0, : len(tokens)] = tokens
    return out


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list[int]  # page ids in block-table order (this slot's refs)
    length: int  # valid tokens (prompt + generated context so far)
    last_tok: int
    admit_seq: int


def _unsupported(config: ServeConfig, mesh) -> list[str]:
    checks = {
        f"kv_dtype={config.kv_dtype!r}": config.kv_dtype != "bf16",
        f"spec_k={config.spec_k}": config.spec_k > 0,
        f"num_shards={config.num_shards}": config.num_shards > 1,
        "mesh": mesh is not None,
        "kv_guard": config.kv_guard,
        "kernel_fallback": config.kernel_fallback,
        f"chaos={config.chaos!r}": bool(config.chaos),
    }
    return [name for name, hit in checks.items() if hit]


def _no_fault_plan() -> None:
    if faults.active() is not None:
        raise NotImplementedError("PagedEngine: fault plans are not ported yet")


class PagedEngine:
    """Continuous-batching server over the paged KV subsystem.

    ``params`` must live on ``device`` (default ``cuda``; the CPU runs the
    kernels' plain versions)."""

    def __init__(self, cfg, params, *, config: ServeConfig | None = None,
                 sampler: sampling.Sampler | None = None,
                 device: str | torch.device = DEFAULT, mesh=None, **legacy):
        if config is not None and legacy:
            raise TypeError(
                f"pass either config=ServeConfig(...) or legacy keywords, "
                f"not both: {sorted(legacy)}")
        if config is None:
            config = config_from_legacy(legacy)
        bad = _unsupported(config, mesh)
        if bad:
            raise NotImplementedError(
                f"PagedEngine: not ported yet: {', '.join(bad)}")
        self.device = resolve(device)
        if params["embed"]["table"].device != self.device:
            raise ValueError(f"params live on {params['embed']['table'].device}, "
                             f"the engine on {self.device}")
        self.config = config
        self.cfg = cfg
        self.params = params
        self.max_batch = config.max_slots
        self.page_size = page_size = config.page_size
        self.table_width = config.cache_len // page_size
        self.cache_len = config.cache_len
        self.prompt_bucket = config.prompt_bucket
        self.prefill_chunk = config.prefill_chunk
        num_pages = config.num_pages
        if num_pages is None:
            # the dense fallback's footprint: one full-length cache per
            # batch slot, plus the null page
            num_pages = 1 + max(self.max_batch * self.table_width, self.table_width)
        self.pool = PagePool(num_pages, page_size)
        self.prefix = PrefixCache(self.pool, page_size)
        self.sched = Scheduler(self.pool, self.prefix, watermark=config.watermark)
        self.caches = lm.init_paged_cache(cfg, num_pages, page_size, config.kv_dtype,
                                          device=self.device)
        self.slots: dict[int, _Slot] = {}
        self._admit_seq = 0
        self._requeue: list[Request] = []  # preempted, waiting to swap in
        self.failed: list[Request] = []  # permanently failed (typed error)
        self.rejections: Counter[str] = Counter()
        self.kernel_calls: Counter[str] = Counter()  # per model-step name
        self.n_preempted = 0
        self.n_cow = 0
        self.n_degrade_requeues = 0
        self.sampler = sampler if sampler is not None else \
            sampling.get_sampler(config.sampler)

    # -- host bookkeeping ---------------------------------------------------
    def _free_slot(self) -> int | None:
        for s in range(self.max_batch):
            if s not in self.slots:
                return s
        return None

    def _table_row(self, pages: list[int]) -> np.ndarray:
        row = np.zeros(self.table_width, np.int32)
        row[: len(pages)] = pages
        return row

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- model steps --------------------------------------------------------
    def _dispatch(self, name: str, fn, *args):
        """Run one model step (``decode`` / ``cold_prefill`` /
        ``suffix_prefill``), counted and traced."""
        self.kernel_calls[name] += 1
        rec = trace.active()
        if rec is None:
            return fn(*args)
        t0 = rec.now()
        out = fn(*args)
        rec.complete(f"engine.{name}", t0, cat="kernel")
        return out

    def _cold_prefill(self, toks, li, table_row, length):
        logits, dense = lm.prefill(self.params, self.cfg, toks, logit_index=li)
        lm.prefill_to_pages(dense, self.caches, table_row, length)
        return logits

    def _suffix_prefill(self, toks, li, table, index, length):
        logits, _ = lm.decode_step(self.params, self.cfg, self.caches, toks, index,
                                   block_table=table, lengths=length)
        return logits[:, li:li + 1]

    def _decode(self, toks, index, table, lengths):
        logits, _ = lm.decode_step(self.params, self.cfg, self.caches, toks, index,
                                   block_table=table, lengths=lengths)
        return logits

    # -- admission ----------------------------------------------------------
    def _reject(self, rej: Rejected) -> Rejected:
        self.rejections[rej.reason] += 1
        return rej

    def _admit(self, req: Request) -> bool | Rejected:
        """Admit a queued request: ``True`` on success, a falsy typed
        :class:`Rejected` otherwise."""
        rec = trace.active()
        if rec is None:
            return self._admit_impl(req)
        t0 = rec.now()
        res = self._admit_impl(req)
        rec.complete("engine.admit", t0, cat="engine",
                     args={"rid": req.rid, "ok": res is True})
        return res

    def _admit_impl(self, req: Request) -> bool | Rejected:
        slot = self._free_slot()
        if slot is None:
            return self._reject(Rejected("no-free-slot"))
        if req._swap is not None:
            return self._swap_in(slot, req)
        replay = bool(req.out)  # a degraded requeue re-prefills its own stream
        tokens = req.prompt + req.out[:-1] if replay else req.prompt
        if len(req.prompt) + req.max_new + 1 > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new exceeds cache_len "
                f"{self.cache_len}")
        # match BEFORE the watermark check: the refs it takes pin the
        # chain against can_admit's prefix eviction; a rejected admission
        # fully unwinds it
        shared, n_matched = self.prefix.match(tokens)
        fresh_needed = self.sched.pages_for(len(tokens) + 1) - len(shared)
        rej = self.sched.check_admission(fresh_needed)
        if rej is not None:
            self.prefix.unmatch(shared, len(tokens))
            return self._reject(rej)

        if n_matched == 0:
            # cold prompt: the dense prefill, scattered into pages
            pages = self.pool.alloc(fresh_needed)
            if pages is None:
                return self._reject(Rejected("pool-dry", fresh_needed))
            toks = pad_to_bucket(tokens, self.prompt_bucket)
            logits = self._dispatch(
                "cold_prefill", self._cold_prefill, self._tensor(toks).long(),
                len(tokens) - 1, self._tensor(self._table_row(pages)), len(tokens))
        else:
            # prefix hit: only the divergent suffix runs, attending to the
            # shared pages, in chunks of ``prefill_chunk`` tokens
            pages = list(shared)
            suffix = tokens[n_matched:]
            chunk = self.prefill_chunk or len(suffix)
            for c0 in range(0, len(suffix), chunk):
                ctoks = suffix[c0: c0 + chunk]
                last_chunk = c0 + chunk >= len(suffix)
                # the final chunk also covers the first decode write
                end = len(tokens) + 1 if last_chunk else n_matched + c0 + len(ctoks)
                need = self.sched.pages_for_range(len(pages) * self.page_size, end)
                if need:
                    got = self.pool.alloc(need)
                    if got is None:
                        fresh_far = [p for p in pages if p not in shared]
                        if fresh_far:
                            self.pool.release(fresh_far)
                        self.prefix.unmatch(shared, len(tokens))
                        return self._reject(Rejected("pool-dry", need))
                    pages.extend(got)
                toks = pad_to_bucket(ctoks, self.prompt_bucket)
                logits = self._dispatch(
                    "suffix_prefill", self._suffix_prefill, self._tensor(toks).long(),
                    len(ctoks) - 1, self._tensor(self._table_row(pages))[None],
                    self._tensor([n_matched + c0]),
                    self._tensor(np.asarray([n_matched + c0 + len(ctoks)], np.int32)))
        self.prefix.insert(tokens, pages)
        self.slots[slot] = _Slot(
            req=req, pages=pages, length=len(tokens),
            last_tok=(req.out[-1] if replay
                      else int(self.sampler.select(logits)[0, -1])),
            admit_seq=self._admit_seq,
        )
        self._admit_seq += 1
        if not replay:
            req.out.append(self.slots[slot].last_tok)
        return True

    def _requeue_degraded(self, slot: int, why: str) -> None:
        """A slot that could not be made writable: free its pages and send
        the request back to the queue as a replay (it re-prefills from its
        own tokens).  Past ``MAX_DEGRADE_REQUEUES`` the request fails with a
        typed error instead of cycling forever."""
        st = self.slots.pop(slot)
        self.pool.release(st.pages)
        st.req._swap = None
        st.req._requeues += 1
        if st.req._requeues > MAX_DEGRADE_REQUEUES:
            st.req.error = f"degraded too often ({why})"
            self.failed.append(st.req)
            return
        self.n_degrade_requeues += 1
        self._requeue.append(st.req)

    # -- preemption (swap to host) and resume -------------------------------
    def _preempt(self, slot: int) -> None:
        st = self.slots.pop(slot)
        ids = self._tensor(np.asarray(st.pages, np.int64))
        data = [(c.k_pages[:, ids].cpu(), c.v_pages[:, ids].cpu()) for c in self.caches]
        st.req._swap = (data, len(st.pages), st.length, st.last_tok)
        rec = trace.active()
        if rec is not None:
            rec.instant("engine.preempt", cat="engine",
                        args={"rid": st.req.rid, "pages": len(st.pages)})
        self.pool.release(st.pages)
        self._requeue.append(st.req)
        self.n_preempted += 1

    def _swap_in(self, slot: int, req: Request):
        """Restore a preempted request: ``True`` or a typed ``Rejected``."""
        data, n_pages, length, last_tok = req._swap
        rej = self.sched.check_admission(n_pages)
        if rej is not None:
            return self._reject(rej)
        pages = self.pool.alloc(n_pages)
        if pages is None:
            return self._reject(Rejected("pool-dry", n_pages))
        ids = self._tensor(np.asarray(pages, np.int64))
        for c, (k, v) in zip(self.caches, data):
            c.k_pages[:, ids] = k.to(self.device)
            c.v_pages[:, ids] = v.to(self.device)
        req._swap = None
        rec = trace.active()
        if rec is not None:
            rec.instant("engine.swap_in", cat="engine",
                        args={"rid": req.rid, "pages": n_pages})
        self.slots[slot] = _Slot(req=req, pages=pages, length=length,
                                 last_tok=last_tok, admit_seq=self._admit_seq)
        self._admit_seq += 1
        return True

    def _pick_victim(self, exclude: set[int] = frozenset()) -> int | None:
        """Youngest running slot outside ``exclude``."""
        order = sorted((s for s in self.slots if s not in exclude),
                       key=lambda s: self.slots[s].admit_seq)
        return self.sched.pick_victim(order)

    # -- copy-on-write / fork ----------------------------------------------
    def fork(self, slot: int, req: Request) -> int | None:
        """Fork a running request: the child shares *every* page of the
        parent (one refcount bump per page, no copies); the next write to
        the shared tail page copies it.  Returns the child slot."""
        child_slot = self._free_slot()
        if child_slot is None:
            return None
        st = self.slots[slot]
        self.pool.share(st.pages)
        self.slots[child_slot] = _Slot(
            req=req, pages=list(st.pages), length=st.length,
            last_tok=st.last_tok, admit_seq=self._admit_seq)
        self._admit_seq += 1
        req.out.extend(st.req.out)
        return child_slot

    def _copy_page(self, src: int, dst: int) -> None:
        for c in self.caches:
            c.k_pages[:, dst] = c.k_pages[:, src]
            c.v_pages[:, dst] = c.v_pages[:, src]

    def _alloc_for_decode(self, n: int, *, exclude: set[int]) -> list[int] | None:
        """Allocate decode pages, escalating: free list -> prefix eviction
        -> preemption of the youngest request not in ``exclude``."""
        while True:
            if self.sched.reclaim(n):
                got = self.pool.alloc(n)
                if got is not None:
                    return got
            victim = self._pick_victim(exclude)
            if victim is None:
                return None
            self._preempt(victim)

    def _ensure_writable(self, slot: int) -> bool:
        """Before a decode step writes position ``length``: make sure its
        page exists in the slot's table and is exclusively owned (COW).
        Returns False when the slot was requeued instead."""
        st = self.slots[slot]
        need = st.length // self.page_size
        if need >= self.table_width:
            raise RuntimeError(f"request {st.req.rid} overran cache_len")
        if need >= len(st.pages):
            got = self._alloc_for_decode(1, exclude={slot})
            if got is None:
                self._requeue_degraded(slot, "page fault with pool exhausted")
                return False
            st.pages.extend(got)
        elif self.pool.refcount(st.pages[need]) > 1:
            res = self.pool.cow(st.pages[need])
            if res is None:  # pool dry: make room, then retry the COW
                got = self._alloc_for_decode(1, exclude={slot})
                if got is not None:
                    self.pool.release(got)
                    res = self.pool.cow(st.pages[need])
            if res is None:
                self._requeue_degraded(slot, "COW failure with pool exhausted")
                return False
            new_id, copied = res
            if copied:
                self._copy_page(st.pages[need], new_id)
                self.n_cow += 1
            st.pages[need] = new_id
        return True

    # -- main loop ----------------------------------------------------------
    def step(self) -> list[Request]:
        """One decode step over the active batch; returns finished requests."""
        _no_fault_plan()
        rec = trace.active()
        if rec is None:
            return self._step_impl()
        t0 = rec.now()
        n_slots = len(self.slots)
        out = self._step_impl()
        rec.complete("engine.step", t0, cat="engine",
                     args={"n_slots": n_slots, "finished": len(out)})
        return out

    def _step_impl(self) -> list[Request]:
        for slot in sorted(self.slots, key=lambda s: self.slots[s].admit_seq):
            if slot in self.slots:  # a page fault may preempt later slots
                self._ensure_writable(slot)
        if not self.slots:
            return []
        toks = np.zeros((self.max_batch, 1), np.int64)
        index = np.zeros(self.max_batch, np.int64)
        lengths = np.zeros(self.max_batch, np.int32)
        table = np.zeros((self.max_batch, self.table_width), np.int32)
        for slot, st in self.slots.items():
            toks[slot, 0] = st.last_tok
            index[slot] = st.length
            lengths[slot] = st.length + 1
            table[slot] = self._table_row(st.pages)
        logits = self._dispatch(
            "decode", self._decode, self._tensor(toks), self._tensor(index),
            self._tensor(table), self._tensor(lengths))
        nxt = self.sampler.select(logits)[:, -1]
        finished = []
        for slot, st in list(self.slots.items()):
            st.length += 1
            st.last_tok = int(nxt[slot])
            st.req.out.append(st.last_tok)
            if len(st.req.out) >= st.req.max_new:
                finished.append(st.req)
                self.pool.release(st.pages)
                del self.slots[slot]
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve ``requests`` to completion; returns them as they finish."""
        _no_fault_plan()
        queue = list(requests)
        done: list[Request] = []
        while queue or self.slots or self._requeue:
            if self._requeue:  # preempted requests re-enter at the front
                queue = self._requeue + queue
                self._requeue = []
            last_rej: Rejected | bool = True
            while queue:
                last_rej = self._admit(queue[0])
                if not last_rej:
                    break
                queue.pop(0)
            if self.slots:
                done.extend(self.step())
                continue
            if not queue:
                continue  # degraded requeues merge next round
            raise RuntimeError(
                f"pool too small to admit any queued request "
                f"(head rejected: {last_rej!r})")
        return done

    # -- auditing ------------------------------------------------------------
    def check(self) -> None:
        """Run the pool auditor with the engine's live holders: every
        running slot's chain plus the prefix tree's own references.
        Raises :class:`repro_torch.serve.guard.GuardViolation` on a leaked
        or dropped reference."""
        holders = [st.pages for st in self.slots.values()]
        holders.append(self.prefix.pages())
        self.pool.check(holders)

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        return {
            "pool": dataclasses.asdict(self.pool.stats),
            "free_pages": self.pool.free_pages,
            "prefix_pages": len(self.prefix),
            "prefix_hit_tokens": self.prefix.hit_tokens,
            "prefix_miss_tokens": self.prefix.miss_tokens,
            "preempted": self.n_preempted,
            "cow_copies": self.n_cow,
            "rejected": dict(self.rejections),
            "degrade_requeues": self.n_degrade_requeues,
            "failed": len(self.failed),
            "kernel_calls": dict(self.kernel_calls),
        }
