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

**One driver, one command order.**  Every call the loop makes on the
engine goes through one :class:`EngineDriver` as a command: admit one
request, one decode tick (each followed by the sweep of the engine's
requeued and failed requests), the abort of the live slots, warmup of
given buckets.  A worker that raises stops the loop: the other worker
returns, every request not yet terminal fails with the error, and
``close()`` raises it.

**Over a mesh** (``PagedEngine(mesh=)``) each rank holds only its own
shards' pages, and the ranks stay consistent only while every rank makes
the same engine calls in the same order, each making collectives.  The
loop decides those calls from wall-clock time in two threads, which no
other rank can reproduce, so the front end — the queue, the workers,
the metrics, the emit worker, the streams and the trace recorder — runs
on rank 0 only, and every other rank calls :func:`follow`:

* rank 0's driver broadcasts each command to the other ranks before it
  makes the call; a follower runs the same driver code for each command
  it receives, with its own :class:`Request` per rid (a requeued request
  comes back with its own tokens and swap state), until the ``stop`` that
  ``close()`` sends.  ``snapshot()`` reads rank 0's engine, whose
  ``stats()`` equal every other rank's;
* the commands travel over a gloo group of their own on CPU tensors,
  apart from the engine's group, with that group's timeout: a follower
  waits between commands in a host collective, not in NCCL.  While the
  loop is idle, rank 0 sends a ``noop`` every :data:`KEEPALIVE_S`, so no
  gap between arrivals reaches the collective timeout;
* rank 0's workers drive the engine one at a time under the lock, each
  on the engine's device (the current CUDA device is per thread), so the
  engine's collectives come from either thread in one order;
* a step that fails and is not retried raises
  :class:`~repro_torch.serve.engine.MeshStepFailed` on every rank: the
  followers end with it, rank 0's driver sends no further command and its
  loop stops as above, so no rank is left waiting in a collective;
* the driver keeps its ``log`` of commands: rank 0's, run again on a
  one-device engine by :func:`replay`, makes the same calls and gives
  the same stats and pages.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
import time

import numpy as np
import torch

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

#: over a mesh, the longest rank 0 lets pass without a command while its
#: loop is idle: a ``noop`` then keeps every follower's wait in the
#: control group far inside that group's collective timeout
KEEPALIVE_S = 1.0

#: the driver's commands, by their code on the wire
COMMANDS = ("noop", "stop", "admit", "tick", "abort", "warmup")


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


def _encode(cmd: tuple) -> list[int]:
    """A command as int64s: its code, then each field tagged — an int (or
    bool) ``0, v``, None ``1``, a tuple of ints ``2, n, v...``."""
    out = [COMMANDS.index(cmd[0])]
    for f in cmd[1:]:
        if f is None:
            out.append(1)
        elif isinstance(f, tuple):
            out += [2, len(f), *f]
        else:
            out += [0, int(f)]
    return out


def _decode(words: list[int]) -> tuple:
    """:func:`_encode`'s inverse."""
    cmd, i = [COMMANDS[words[0]]], 1
    while i < len(words):
        tag = words[i]
        if tag == 0:
            cmd.append(words[i + 1])
            i += 2
        elif tag == 1:
            cmd.append(None)
            i += 1
        else:
            n = words[i + 1]
            cmd.append(tuple(words[i + 2:i + 2 + n]))
            i += 2 + n
    return tuple(cmd)


def _control_group(engine: PagedEngine):
    """A gloo group over the engine's ranks for the driver's commands,
    apart from the engine's own group, with that group's collective
    timeout (torch's default where the backend does not say)."""
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda" if engine.mesh.device_type == "cuda" else "cpu")
    try:
        timeout = engine._group._get_backend(dev).options._timeout
    except (AttributeError, RuntimeError):
        timeout = None
    if not isinstance(timeout, datetime.timedelta):
        timeout = dist.default_pg_timeout
    return dist.new_group(engine._ranks, backend="gloo", timeout=timeout)


class EngineDriver:
    """Every call a :class:`ServeLoop` makes on its engine, as a command:
    ``admit`` one request (its rid, and its prompt and ``max_new`` the
    first time the rid is sent), one decode ``tick``, the ``abort`` of the
    live slots, ``warmup`` of given buckets; after an admission and a tick,
    the sweep of the engine's requeued and failed requests.

    On one device a command is just run.  Over a mesh every rank must make
    the same engine calls in the same order (each makes collectives), so
    rank 0's driver broadcasts each command to the other ranks over a gloo
    group of its own (:func:`_control_group`, CPU tensors: a follower
    waits between ticks in a host collective) before it runs it, and a
    follower (:meth:`follow`) runs each command it receives.  A follower
    keeps its own :class:`Request` per rid, so a requeued request comes
    back with its own tokens and swap state.  While rank 0 is idle it sends
    a ``noop`` every :data:`KEEPALIVE_S` (:meth:`keepalive`); ``stop`` ends
    the followers.  Once a command raises — over a mesh a step that fails and
    is not retried raises :class:`~repro_torch.serve.engine.MeshStepFailed`
    on every rank — the driver sends nothing more.

    ``log`` keeps every command run, ``noop`` and ``stop`` aside: rank 0's
    replayed on a one-device engine (:func:`replay`) makes the same calls."""

    def __init__(self, engine: PagedEngine):
        self.engine = engine
        self.requests: dict[int, Request] = {}
        self.log: list[tuple] = []
        self.error: BaseException | None = None
        self._n_failed_seen = len(engine.failed)
        self._control = None
        if engine.mesh is not None and engine.n_ranks > 1:
            self._control = _control_group(engine)
            self._root = engine._ranks[0]
        self._last_send = time.monotonic()

    # -- rank 0 (or one device): give a command -------------------------------
    def admit(self, req: Request):
        """``(result, requeued, failed)``: :meth:`PagedEngine._admit`'s
        result, then the sweep."""
        first = req.rid not in self.requests
        self.requests[req.rid] = req
        return self._execute(("admit", req.rid, tuple(req.prompt) if first else None,
                            req.max_new if first else None))

    def tick(self):
        """``(finished, requeued, failed)``: one :meth:`PagedEngine.step`,
        then the sweep."""
        return self._execute(("tick",))

    def abort(self) -> list[Request]:
        """Release every live slot (``_release``: over a mesh it also drops
        the mirrors of the pages it frees); returns the slots' requests."""
        return self._execute(("abort",))

    def warmup(self, cold, suffix, decode: bool, verify: bool, draft) -> int:
        """One raw model step per cold-prefill and suffix bucket, the decode
        and verify shapes, and the draft's programs for ``draft`` buckets:
        the number of steps run."""
        return self._execute(("warmup", tuple(cold), tuple(suffix), decode, verify, tuple(draft)))

    def keepalive(self) -> None:
        """Over a mesh, a ``noop`` when no command went out for
        :data:`KEEPALIVE_S`."""
        if self._control is not None and self.error is None \
                and time.monotonic() - self._last_send >= KEEPALIVE_S:
            self._execute(("noop",))

    def stop(self) -> None:
        """End the followers, once (nothing is sent after a failed
        command); the driver then takes no further command."""
        if self._control is not None and self.error is None:
            self._execute(("stop",))
            self._control = None
            self.error = RuntimeError("the engine driver was stopped")

    def _execute(self, cmd: tuple):
        if self.error is not None:
            raise RuntimeError("the engine driver takes no further command") from self.error
        if self._control is not None:
            self._send(cmd)
        if cmd[0] in ("noop", "stop"):
            return None
        return self._run(cmd)

    # -- every rank -------------------------------------------------------------
    def _run(self, cmd: tuple):
        self.log.append(cmd)
        try:
            return getattr(self, f"_{cmd[0]}")(*cmd[1:])
        except Exception as e:
            self.error = e
            raise

    def _admit(self, rid, prompt, max_new):
        req = self.requests.get(rid)
        if req is None:
            req = self.requests[rid] = Request(rid=rid, prompt=list(prompt), max_new=max_new)
        return (self.engine._admit(req), *self._sweep())

    def _tick(self):
        return (self.engine.step(), *self._sweep())

    def _sweep(self) -> tuple[list[Request], list[Request]]:
        eng = self.engine
        requeued = list(eng._requeue)
        eng._requeue.clear()
        failed = eng.failed[self._n_failed_seen:]
        self._n_failed_seen = len(eng.failed)
        return requeued, failed

    def _abort(self) -> list[Request]:
        eng = self.engine
        out = []
        for slot, st in list(eng.slots.items()):
            eng._release(st.pages)
            del eng.slots[slot]
            out.append(st.req)
        return out

    def _warmup(self, cold, suffix, decode, verify, draft) -> int:
        """The raw steps write only the null page: no pool page, prefix
        entry or fault-site hit is consumed, and no collective made."""
        eng = self.engine
        zeros = lambda *shape: eng._tensor(np.zeros(shape, np.int64))  # noqa: E731
        filled = lambda k: eng._tensor(np.full(eng.max_batch, k, np.int32))  # noqa: E731
        for b in cold:
            eng._cold_prefill(zeros(1, b), 0, eng._tensor(np.zeros(eng.table_width, np.int32)), 1)
        for b in suffix:
            eng._suffix_prefill(zeros(1, b), 0,
                                eng._tensor(np.zeros((1, eng.table_width), np.int32)),
                                zeros(1), eng._tensor(np.ones(1, np.int32)))
        table = eng._tensor(np.zeros((eng.max_batch, eng.table_width), np.int32))
        if decode:
            eng._decode(zeros(eng.max_batch, 1), zeros(eng.max_batch), table, filled(1))
        n = len(cold) + len(suffix) + bool(decode)
        if verify:
            # the speculative tick's steps: the s = spec_k + 1 verify step
            # (against the null page) plus the draft's own prefill buckets
            # and s = 1 decode
            eng._decode(zeros(eng.max_batch, eng.spec_k + 1), zeros(eng.max_batch), table,
                        filled(eng.spec_k + 1))
            n += 1 + eng.spec.warmup(set(draft), eng.spec_k)
        return n

    # -- the wire ---------------------------------------------------------------
    def _send(self, cmd: tuple) -> None:
        import torch.distributed as dist

        words = _encode(cmd)
        dist.broadcast(torch.tensor([len(words)], dtype=torch.int64), self._root,
                       group=self._control)
        dist.broadcast(torch.tensor(words, dtype=torch.int64), self._root, group=self._control)
        self._last_send = time.monotonic()

    def _recv(self) -> tuple:
        import torch.distributed as dist

        n = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(n, self._root, group=self._control)
        words = torch.zeros(int(n), dtype=torch.int64)
        dist.broadcast(words, self._root, group=self._control)
        return _decode(words.tolist())

    def follow(self) -> dict[int, Request]:
        """A follower rank: run each command rank 0 sends until ``stop``;
        its requests by rid.  An error of a command ends the follower with
        that error (rank 0 meets the same one and sends nothing more)."""
        if self._control is None or self.engine.rank == 0:
            raise ValueError("follow() runs on a mesh rank other than 0")
        while True:
            cmd = self._recv()
            if cmd[0] == "stop":
                return self.requests
            if cmd[0] != "noop":
                self._run(cmd)


def follow(engine: PagedEngine) -> EngineDriver:
    """Rank ``r > 0`` of a mesh engine served by rank 0's :class:`ServeLoop`:
    run rank 0's commands on this rank's engine until rank 0's ``close``;
    returns the driver (its ``requests`` and ``log``)."""
    driver = EngineDriver(engine)
    driver.follow()
    return driver


def replay(engine: PagedEngine, log: list[tuple]) -> EngineDriver:
    """Run a driver's command ``log`` on ``engine`` (a one-device engine:
    the calls a mesh loop made, made again); returns the driver."""
    driver = EngineDriver(engine)
    for cmd in log:
        driver._run(cmd)
    return driver


class ServeLoop:
    """See module docstring.  All engine access — admission, decode
    ticks, warmup — goes through one :class:`EngineDriver` and is
    serialized on one lock; the three workers coordinate through a
    condition on that lock plus the emit queue, so submission and stream
    consumption never block on device work.  Over a mesh the loop runs on
    rank 0 only; every other rank calls :func:`follow`."""

    def __init__(self, engine: PagedEngine, *, config: ServeConfig | None = None,
                 metrics: ServeMetrics | None = None,
                 max_slots: int | None = None, queue_cap: int | None = None,
                 detokenize=None, clock=time.monotonic,
                 admission_retry_s: float = 0.005):
        if engine.rank != 0:
            raise ValueError(f"mesh rank {engine.rank} follows rank 0's ServeLoop: "
                             f"call follow(engine) there")
        if config is not None:
            # the typed config fills loop knobs not given explicitly
            max_slots = config.max_slots if max_slots is None else max_slots
            queue_cap = config.queue_cap if queue_cap is None else queue_cap
        self.engine = engine
        self.driver = EngineDriver(engine)
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
        self._error: BaseException | None = None  # a worker's, raised by close()
        self._warm_cold: set[int] = set()
        self._warm_suffix: set[int] = set()
        self._warm_decode = False
        self._warm_verify = False
        self._threads = [
            threading.Thread(target=self._engine_worker, args=(self._prefill_worker,),
                             name="serve-prefill", daemon=True),
            threading.Thread(target=self._engine_worker, args=(self._decode_worker,),
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
            if self._error is not None:
                raise RuntimeError("ServeLoop stopped: a worker raised") from self._error
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

    def _sweep_locked(self, requeued: list[Request], failed: list[Request]) -> None:
        """Take the driver's sweep of engine-side degradations:
        preempted/requeued requests re-enter the admission queue at the
        *front* (they were admitted before anything queued behind them),
        engine-failed requests go terminal."""
        for req in reversed(requeued):
            sreq = self._by_rid[req.rid]
            sreq.state = Lifecycle.QUEUED
            self._queue.insert(0, sreq)
        for req in failed:
            self._finish_locked(self._by_rid[req.rid], Lifecycle.FAILED, req.error)

    def _done_serving(self) -> bool:
        return self._closing and not self._queue \
            and not self.engine.slots and not self.engine._requeue

    # -- workers ------------------------------------------------------------
    def _engine_worker(self, body) -> None:
        """A worker that drives the engine: on the engine's device (the
        current CUDA device is per thread), and where it raises, the loop
        stops as :meth:`_fail_locked` says."""
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        try:
            body()
        except Exception as e:  # noqa: BLE001 — raised again by close()
            with self._work:
                self._fail_locked(e)

    def _fail_locked(self, err: BaseException) -> None:
        """A worker raised (over a mesh, e.g. a step that failed and is not
        retried, which every rank raises): the other worker stops, every
        request not yet terminal fails with the error, the driver sends no
        further command, and :meth:`close` raises ``err``."""
        if self._error is None:
            self._error = err
        why = f"{type(err).__name__}: {err}"
        for sreq in self._by_rid.values():
            if sreq.state not in TERMINAL:
                self._finish_locked(sreq, Lifecycle.FAILED, why)
        self._queue.clear()
        self._work.notify_all()

    def _prefill_worker(self) -> None:
        eng = self.engine
        while True:
            with self._work:
                if self._done_serving() or self._abort or self._error is not None:
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
                res, requeued, failed = self.driver.admit(head.engine_req)  # pays the prefill
                self._sweep_locked(requeued, failed)
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
                if self._error is not None:
                    return
                if self._done_serving():
                    self._work.notify_all()
                    return
                if self._abort:
                    # non-draining shutdown: fail live slots, free pages
                    for req in self.driver.abort():
                        self._finish_locked(self._by_rid[req.rid], Lifecycle.FAILED,
                                            "shutdown")
                    self._work.notify_all()
                    return
                if not eng.slots:
                    self.driver.keepalive()
                    self._work.wait(timeout=self._retry_s)
                    continue
                n_live = len(eng.slots)
                rec = trace.active()
                t_tick = self.clock() if rec is not None else 0.0
                finished, requeued, failed = self.driver.tick()
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
                self._sweep_locked(requeued, failed)
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
        fault-plan hits are consumed.  Over a mesh every rank runs them.
        Returns the number of steps run (the JAX package's count of
        compiled programs)."""
        eng = self.engine
        rec = trace.active()
        t0 = self.clock() if rec is not None else 0.0
        with self._work:
            cold = sorted({bucket_len(ln, eng.prompt_bucket) for ln in prompt_lens}
                          - self._warm_cold)
            suffix = sorted({bucket_len(ln, eng.prompt_bucket) for ln in suffix_lens}
                            - self._warm_suffix)
            dec = decode and not self._warm_decode
            verify = decode and eng.spec is not None and not self._warm_verify
            draft = sorted({bucket_len(ln, eng.prompt_bucket) for ln in prompt_lens})
            n = 0
            if cold or suffix or dec or verify:
                n = self.driver.warmup(cold, suffix, dec, verify, draft if verify else ())
            self._warm_cold.update(cold)
            self._warm_suffix.update(suffix)
            self._warm_decode |= dec
            self._warm_verify |= verify
            for _ in range(n):
                self.metrics.record_bucket_compile()
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
        try:
            if warmup:
                self.warmup_for_trace(trace)
            t0 = self.clock()
            for a in trace:
                if realtime:
                    delay = a.t * time_scale - (self.clock() - t0)
                    if delay > 0:
                        time.sleep(delay)
                self.submit(a.prompt, a.max_new, rid=a.rid)
        finally:
            self.close(drain=True)  # raises a worker's error, if one raised
        return dict(self._by_rid)

    def close(self, drain: bool = True, timeout: float | None = 60.0) -> None:
        """Stop accepting submissions; with ``drain`` let every queued
        and live request finish, otherwise abort live work as FAILED
        ("shutdown").  Flushes the emit queue and joins the workers —
        after close every stream has ended — then, over a mesh, stops the
        followers.  Raises the error a worker raised, if one did."""
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
        if self._error is not None:
            raise self._error
        self.driver.stop()

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat metrics snapshot for this loop (see
        :meth:`repro_torch.serve.metrics.ServeMetrics.snapshot`)."""
        return self.metrics.snapshot(engine=self.engine,
                                     fault_plan=faults.active())
