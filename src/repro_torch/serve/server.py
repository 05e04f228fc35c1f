"""Async continuous-batching serve loop over :class:`PagedEngine`: the port
of the JAX package's ``serve/server.py``.

The engine (`engine.py`) is a library: callers hand-drive
``_admit``/``step`` turn by turn.  This module is the *server* — a
JetStream-style loop that turns asynchronously-arriving requests into
per-request token streams while the engine decodes continuously:

* **Slot-based request lifecycle**::

      QUEUED -> PREFILLING -> DECODING -> DRAINED
           \\-> REJECTED (typed, at submit or on permanent backpressure)
            \\-> FAILED   (engine-degraded past its requeue bound, shutdown)

* **Background bucketed-prefill worker** — admits the queue head FIFO
  under the engine lock, between decode ticks.  Prompts pad to length
  buckets; ``warmup()`` runs one step per bucket and per decode shape a
  trace will touch, so that the first launch of each kernel — which
  builds (``nvcc``) and loads its library, and sizes its workspaces —
  happens before the trace and first-token latency measures serving.
* **Decode worker** — continuously batches *all* live slots through one
  ``engine.step()`` per tick; prefills land between ticks, so admission
  latency is bounded by one tick, not by the batch draining.
* **Detokenize/emit worker** — decode and prefill push raw token ids on
  an emit queue; this worker timestamps them into the metrics
  histograms and yields them on each request's :class:`TokenStream`
  (optionally detokenized), so a slow consumer never blocks a tick.
* **Admission backpressure** — driven by the typed
  :class:`~repro_torch.serve.scheduler.Rejected` results: the FIFO head is
  *retried, never skipped* (no starvation of large requests by small
  later arrivals), and retries wait for the pages/slots the rejection
  named (``retry_after_pages``) instead of hammering the scheduler.
  Requests that can never fit — or that overflow ``queue_cap`` — are
  REJECTED with a typed reason at submit time.
* **Clean drain/shutdown** — ``close(drain=True)`` stops admissions,
  lets the queue and every live slot finish, flushes the emit queue,
  and joins the workers; ``drain=False`` aborts live work as FAILED
  ("shutdown") with the pool left audit-green.

Token-stream determinism: admission is FIFO in arrival order and the
decode math is row-independent, so the loop's per-request streams are
**bitwise identical** to driving the same request sequence through the
synchronous ``PagedEngine.run`` — the correctness oracle CI pairs every
load-smoke run against.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
import time

import numpy as np

from repro_torch.obs import trace
from repro_torch.serve import faults
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import PagedEngine, Request
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import bucket_len

# consecutive idle-engine rejections of the queue head tolerated while a
# fault plan is armed (transient injected rejections) before the head is
# failed — mirrors PagedEngine.run's stall bound
_MAX_HEAD_STALLS = 100


class Lifecycle(enum.Enum):
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    DECODING = "DECODING"
    DRAINED = "DRAINED"
    REJECTED = "REJECTED"
    FAILED = "FAILED"


TERMINAL = (Lifecycle.DRAINED, Lifecycle.REJECTED, Lifecycle.FAILED)

_END = object()


class TokenStream:
    """Blocking per-request token stream: iterate to consume tokens as
    the server emits them; iteration ends when the request reaches a
    terminal state.  Safe to iterate from any thread."""

    def __init__(self):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.closed = threading.Event()

    def _push(self, tok: int) -> None:
        self._q.put(tok)

    def _close(self) -> None:
        self.closed.set()
        self._q.put(_END)

    def __iter__(self):
        return self

    def __next__(self) -> int:
        item = self._q.get()
        if item is _END:
            self._q.put(_END)  # stay closed for any later consumer
            raise StopIteration
        return item


@dataclasses.dataclass
class ServedRequest:
    """The server-side view of one request: lifecycle state, the engine
    request it wraps (whose ``out`` is the canonical token list), and
    the stream a consumer reads."""

    rid: int
    engine_req: Request
    arrival_t: float
    stream: TokenStream
    state: Lifecycle = Lifecycle.QUEUED
    error: str | None = None
    text: str = ""  # accumulated detokenized output (when detokenize set)
    _n_emitted: int = 0  # tokens flushed to the emit queue (under loop lock)

    @property
    def tokens(self) -> list[int]:
        return list(self.engine_req.out)

    def result(self, timeout: float | None = None) -> list[int]:
        """Block until the request reaches a terminal state; return the
        full token list."""
        if not self.stream.closed.wait(timeout):
            raise TimeoutError(f"request {self.rid} still {self.state.name}")
        return self.tokens


class ServeLoop:
    """See module docstring.  All engine access — admission, decode
    ticks, warmup — is serialized on one lock; the three workers
    coordinate through a condition on that lock plus the emit queue, so
    submission and stream consumption never block on device work."""

    def __init__(self, engine: PagedEngine, *, config: ServeConfig | None = None,
                 metrics: ServeMetrics | None = None,
                 max_slots: int | None = None, queue_cap: int | None = None,
                 detokenize=None, clock=time.monotonic,
                 admission_retry_s: float = 0.005):
        if engine.mesh is not None:
            from repro_torch.launch.mesh import MESH_SERVE_ITEM

            raise NotImplementedError(
                f"ServeLoop over PagedEngine(mesh=): not ported yet: {MESH_SERVE_ITEM}")
        if config is not None:
            # the typed config fills loop knobs not given explicitly
            max_slots = config.max_slots if max_slots is None else max_slots
            queue_cap = config.queue_cap if queue_cap is None else queue_cap
        self.engine = engine
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.max_slots = min(max_slots or engine.max_batch, engine.max_batch)
        self.queue_cap = queue_cap
        self.detokenize = detokenize
        self.clock = clock
        self._retry_s = admission_retry_s
        self._mu = threading.Lock()
        self._work = threading.Condition(self._mu)
        self._queue: list[ServedRequest] = []
        self._by_rid: dict[int, ServedRequest] = {}
        self._emit_q: queue.SimpleQueue = queue.SimpleQueue()
        self._rids = itertools.count()
        self._closing = False
        self._abort = False
        self._release_gen = 0  # bumped when pages/slots may have freed
        self._head_stalls = 0
        self._n_failed_seen = len(engine.failed)
        self._warm_cold: set[int] = set()
        self._warm_suffix: set[int] = set()
        self._warm_decode = False
        self._warm_verify = False
        self._threads = [
            threading.Thread(target=self._prefill_worker,
                             name="serve-prefill", daemon=True),
            threading.Thread(target=self._decode_worker,
                             name="serve-decode", daemon=True),
            threading.Thread(target=self._emit_worker,
                             name="serve-emit", daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- submission ---------------------------------------------------------
    def _never_fits(self, req: Request) -> str | None:
        """Typed reason a request can never be admitted, else None."""
        eng = self.engine
        if len(req.prompt) + req.max_new + 1 > eng.cache_len:
            return "too-long"
        demand = eng.sched.pages_for(len(req.prompt) + req.max_new + 1)
        # a request is admitted onto ONE shard, so the bound is the
        # per-shard capacity (for num_shards=1 this is the whole pool
        # minus the null page, as before)
        if demand > eng.pool.pages_per_shard:
            return "too-large"
        return None

    def submit(self, prompt, max_new: int, *, rid: int | None = None,
               arrival_t: float | None = None) -> ServedRequest:
        """Enqueue one request; returns immediately with its
        :class:`ServedRequest` handle (stream + lifecycle state).  A
        request that can never fit — or that lands on a full bounded
        queue — is REJECTED here with a typed reason."""
        t = arrival_t if arrival_t is not None else self.clock()
        with self._work:
            if self._closing:
                raise RuntimeError("ServeLoop is closed to new submissions")
            if rid is None:
                rid = next(r for r in self._rids if r not in self._by_rid)
            elif rid in self._by_rid:
                raise ValueError(f"duplicate rid {rid}")
            sreq = ServedRequest(
                rid=rid, arrival_t=t, stream=TokenStream(),
                engine_req=Request(rid=rid, prompt=list(prompt),
                                   max_new=max_new),
            )
            self._by_rid[rid] = sreq
            self.metrics.record_arrival(rid, t)
            rec = trace.active()
            if rec is not None:
                # one async span per request, QUEUED -> terminal, closed
                # by the emit worker — the trace twin of metrics.Timeline
                rec.async_begin("request", rid, cat="serve", ts=t,
                                args={"prompt": len(sreq.engine_req.prompt),
                                      "max_new": max_new})
            reason = self._never_fits(sreq.engine_req)
            if reason is None and self.queue_cap is not None \
                    and len(self._queue) >= self.queue_cap:
                reason = "queue-full"
            if reason is not None:
                self.metrics.record_rejected(reason)
                self._finish_locked(sreq, Lifecycle.REJECTED, reason)
                return sreq
            self._queue.append(sreq)
            self._work.notify_all()
            return sreq

    # -- shared locked helpers ----------------------------------------------
    def _finish_locked(self, sreq: ServedRequest, state: Lifecycle,
                       error: str | None = None) -> None:
        sreq.state = state
        sreq.error = error
        # the close rides the emit queue so every already-flushed token
        # reaches the stream (and the metrics) before the end marker
        self._emit_q.put(("close", sreq))

    def _flush_tokens_locked(self, sreq: ServedRequest, t: float) -> None:
        out = sreq.engine_req.out
        while sreq._n_emitted < len(out):
            self._emit_q.put(("tok", sreq, out[sreq._n_emitted], t))
            sreq._n_emitted += 1

    def _sweep_engine_locked(self) -> None:
        """Collect engine-side degradations: preempted/requeued requests
        re-enter the admission queue at the *front* (they were admitted
        before anything queued behind them), engine-failed requests go
        terminal."""
        eng = self.engine
        if eng._requeue:
            for req in reversed(eng._requeue):
                sreq = self._by_rid[req.rid]
                sreq.state = Lifecycle.QUEUED
                self._queue.insert(0, sreq)
            eng._requeue.clear()
        if len(eng.failed) > self._n_failed_seen:
            for req in eng.failed[self._n_failed_seen:]:
                self._finish_locked(self._by_rid[req.rid], Lifecycle.FAILED,
                                    req.error)
            self._n_failed_seen = len(eng.failed)

    def _done_serving(self) -> bool:
        return self._closing and not self._queue \
            and not self.engine.slots and not self.engine._requeue

    # -- workers ------------------------------------------------------------
    def _prefill_worker(self) -> None:
        eng = self.engine
        while True:
            with self._work:
                if self._done_serving() or self._abort:
                    return
                if not self._queue:
                    self._work.wait(timeout=self._retry_s)
                    continue
                if len(eng.slots) >= self.max_slots:
                    # every lane budgeted: wait for a decode release
                    gen = self._release_gen
                    self._work.wait_for(
                        lambda: self._release_gen != gen or self._abort,
                        timeout=self._retry_s)
                    continue
                head = self._queue[0]
                head.state = Lifecycle.PREFILLING
                overlapped = bool(eng.slots)
                t_start = self.clock()  # queue wait ends here; TTFT also
                res = eng._admit(head.engine_req)  # pays the prefill itself
                self._sweep_engine_locked()
                if res:
                    if self._queue and self._queue[0] is head:
                        self._queue.pop(0)
                    self._head_stalls = 0
                    head.state = Lifecycle.DECODING
                    # one clock read serves as both the prefill-span end
                    # and the first token's emit timestamp, so the trace
                    # decomposition (queue_wait + prefill) telescopes to
                    # exactly the TTFT metrics.py records
                    t_done = self.clock()
                    self.metrics.record_admitted(head.rid, t_start,
                                                 overlapped=overlapped)
                    self._flush_tokens_locked(head, t_done)
                    rec = trace.active()
                    if rec is not None:
                        rec.complete("request.queue_wait", head.arrival_t,
                                     t_start, cat="serve",
                                     args={"rid": head.rid})
                        rec.complete("request.prefill", t_start, t_done,
                                     cat="serve",
                                     args={"rid": head.rid,
                                           "overlapped": overlapped})
                    self._work.notify_all()
                    continue
                # typed backpressure: the head stays at the front (FIFO —
                # a large request is never starved by smaller later
                # arrivals) and is retried when the rejection's demand
                # can be met, not before
                head.state = Lifecycle.QUEUED
                self.metrics.record_rejected(res.reason)
                rec = trace.active()
                if rec is not None:
                    rec.instant("admission.backpressure", cat="serve",
                                args={"rid": head.rid, "reason": res.reason,
                                      "retry_after_pages":
                                          res.retry_after_pages})
                if not eng.slots and not eng._requeue:
                    # nothing running will ever free pages; without an
                    # armed fault plan this is permanent (mirrors
                    # PagedEngine.run's pool-too-small error, degraded to
                    # a typed per-request failure so the loop survives)
                    self._head_stalls += 1
                    if faults.active() is None \
                            or self._head_stalls > _MAX_HEAD_STALLS:
                        if self._queue and self._queue[0] is head:
                            self._queue.pop(0)
                        self._head_stalls = 0
                        self._finish_locked(
                            head, Lifecycle.FAILED,
                            f"unservable with idle engine: {res.reason} "
                            f"(retry_after_pages={res.retry_after_pages})")
                    continue
                free0 = eng.pool.free_pages
                need = res.retry_after_pages
                gen = self._release_gen
                self._work.wait_for(
                    lambda: self._release_gen != gen
                    and (need == 0 or eng.pool.free_pages >= free0 + need
                         or not eng.slots),
                    timeout=self._retry_s)

    def _decode_worker(self) -> None:
        eng = self.engine
        while True:
            with self._work:
                if self._done_serving():
                    self._work.notify_all()
                    return
                if self._abort:
                    # non-draining shutdown: fail live slots, free pages
                    for slot, st in list(eng.slots.items()):
                        eng.pool.release(st.pages)
                        del eng.slots[slot]
                        self._finish_locked(self._by_rid[st.req.rid],
                                            Lifecycle.FAILED, "shutdown")
                    self._work.notify_all()
                    return
                if not eng.slots:
                    self._work.wait(timeout=self._retry_s)
                    continue
                n_live = len(eng.slots)
                rec = trace.active()
                t_tick = self.clock() if rec is not None else 0.0
                finished = eng.step()
                t = self.clock()
                self.metrics.record_tick(n_live)
                if rec is not None:
                    rec.complete("decode.tick", t_tick, t, cat="serve",
                                 args={"n_slots": n_live,
                                       "finished": len(finished)})
                    rec.counter("live_slots", len(eng.slots), ts=t)
                for req in [st.req for st in eng.slots.values()] + finished:
                    self._flush_tokens_locked(self._by_rid[req.rid], t)
                for req in finished:
                    self._finish_locked(self._by_rid[req.rid],
                                        Lifecycle.DRAINED)
                self._sweep_engine_locked()
                self._release_gen += 1
                self._work.notify_all()
            # outside the lock: one scheduler slice so a pending
            # admission (or submit) can interleave between ticks
            time.sleep(0)

    def _emit_worker(self) -> None:
        while True:
            item = self._emit_q.get()
            kind = item[0]
            if kind == "stop":
                return
            if kind == "tok":
                _, sreq, tok, t = item
                self.metrics.record_token(sreq.rid, t)
                rec = trace.active()
                if rec is not None:
                    now = self.clock()
                    rec.instant("token.emit", cat="serve", ts=now,
                                args={"rid": sreq.rid,
                                      "lag_ms": (now - t) * 1e3})
                if self.detokenize is not None:
                    sreq.text += self.detokenize(tok)
                sreq.stream._push(tok)
            else:  # "close"
                _, sreq = item
                self.metrics.record_done(sreq.rid, sreq.state.name)
                rec = trace.active()
                if rec is not None:
                    rec.async_end("request", sreq.rid, cat="serve",
                                  args={"state": sreq.state.name})
                sreq.stream._close()

    # -- warmup (each bucket's and decode shape's first launches) ------------
    def warmup(self, prompt_lens=(), *, suffix_lens=(), decode: bool = True) -> int:
        """Run one model step per length *bucket* and decode shape a
        workload will touch: the first launch of each kernel builds and
        loads its library and sizes its workspaces, which the trace then
        does not pay.  The warm calls write only the null page (page 0 —
        the padded-write sink), so no pool pages, prefix-cache entries, or
        fault-plan hits are consumed.  Returns the number of steps run (the
        JAX package's count of compiled programs)."""
        eng = self.engine
        n = 0
        rec = trace.active()
        t0 = self.clock() if rec is not None else 0.0
        zeros = lambda *shape: eng._tensor(np.zeros(shape, np.int64))  # noqa: E731
        filled = lambda k: eng._tensor(np.full(eng.max_batch, k, np.int32))  # noqa: E731
        with self._work:
            for ln in prompt_lens:
                b = bucket_len(ln, eng.prompt_bucket)
                if b in self._warm_cold:
                    continue
                eng._cold_prefill(zeros(1, b), 0, eng._tensor(np.zeros(eng.table_width,
                                                                      np.int32)), 1)
                self._warm_cold.add(b)
                self.metrics.record_bucket_compile()
                n += 1
            for ln in suffix_lens:
                b = bucket_len(ln, eng.prompt_bucket)
                if b in self._warm_suffix:
                    continue
                eng._suffix_prefill(zeros(1, b), 0,
                                    eng._tensor(np.zeros((1, eng.table_width), np.int32)),
                                    zeros(1), eng._tensor(np.ones(1, np.int32)))
                self._warm_suffix.add(b)
                self.metrics.record_bucket_compile()
                n += 1
            table = eng._tensor(np.zeros((eng.max_batch, eng.table_width), np.int32))
            if decode and not self._warm_decode:
                eng._decode(zeros(eng.max_batch, 1), zeros(eng.max_batch), table, filled(1))
                self._warm_decode = True
                self.metrics.record_bucket_compile()
                n += 1
            if decode and eng.spec is not None and not self._warm_verify:
                # the speculative tick's steps: the s = spec_k + 1 verify
                # step (against the null page) plus the draft's own
                # prefill buckets and s = 1 decode
                eng._decode(zeros(eng.max_batch, eng.spec_k + 1), zeros(eng.max_batch), table,
                            filled(eng.spec_k + 1))
                self._warm_verify = True
                self.metrics.record_bucket_compile()
                n += 1
                buckets = {bucket_len(ln, eng.prompt_bucket) for ln in prompt_lens}
                for _ in range(eng.spec.warmup(buckets, eng.spec_k)):
                    self.metrics.record_bucket_compile()
                    n += 1
        if rec is not None and n:
            rec.complete("compile.warmup", t0, self.clock(), cat="serve",
                         args={"programs": n})
        return n

    def warmup_for_trace(self, trace) -> int:
        """Warm every bucket a :class:`~repro_torch.serve.loadgen.Arrival`
        trace can touch: cold-prefill buckets for the full prompt
        lengths, suffix buckets for shared-prefix divergences (any
        suffix length can occur, so warm the chunk/bucket sizes the
        engine would use)."""
        eng = self.engine
        lens = {len(a.prompt) for a in trace}
        suffixes = set()
        if any(a.shared for a in trace):
            # a shared arrival's divergent suffix is its prompt minus
            # however much of the prefix chain is cached: whole pages
            # only, so the possible suffix lengths are quantized
            for a in trace:
                if not a.shared:
                    continue
                chunk = eng.prefill_chunk
                for n_shared in range(0, len(a.prompt), eng.page_size):
                    suffix = len(a.prompt) - n_shared
                    if chunk:
                        suffixes.add(min(chunk, suffix))
                        if suffix % chunk:
                            suffixes.add(suffix % chunk)
                    else:
                        suffixes.add(suffix)
        return self.warmup(lens, suffix_lens=suffixes)

    # -- trace driving + shutdown -------------------------------------------
    def run_trace(self, trace, *, warmup: bool = True, realtime: bool = True,
                  time_scale: float = 1.0) -> dict[int, ServedRequest]:
        """Drive a load-generator trace end to end: warm the buckets,
        submit each arrival at its timestamp (``realtime=False`` submits
        back-to-back), drain, and return ``{rid: ServedRequest}``."""
        if warmup:
            self.warmup_for_trace(trace)
        t0 = self.clock()
        for a in trace:
            if realtime:
                delay = a.t * time_scale - (self.clock() - t0)
                if delay > 0:
                    time.sleep(delay)
            self.submit(a.prompt, a.max_new, rid=a.rid)
        self.close(drain=True)
        return dict(self._by_rid)

    def close(self, drain: bool = True, timeout: float | None = 60.0) -> None:
        """Stop accepting submissions; with ``drain`` let every queued
        and live request finish, otherwise abort live work as FAILED
        ("shutdown").  Flushes the emit queue and joins the workers —
        after close every stream has ended."""
        with self._work:
            self._closing = True
            if not drain:
                self._abort = True
                for sreq in self._queue:
                    self._finish_locked(sreq, Lifecycle.FAILED, "shutdown")
                self._queue.clear()
            self._work.notify_all()
        for t in self._threads[:2]:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(f"{t.name} did not stop within {timeout}s")
        self._emit_q.put(("stop",))
        self._threads[2].join(timeout)

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat metrics snapshot for this loop (see
        :meth:`repro_torch.serve.metrics.ServeMetrics.snapshot`)."""
        return self.metrics.snapshot(engine=self.engine,
                                     fault_plan=faults.active())
