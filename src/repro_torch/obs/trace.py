"""Thread-safe structured tracing with a near-zero-cost disabled path.

Call sites follow the ``faults.fires`` pattern — one module-global read
decides everything:

    rec = trace.active()
    if rec is not None:
        t0 = rec.now()
        ...
        rec.complete("engine.decode", t0, cat="kernel", args={...})

When no recorder is armed ``active()`` is a single global load returning
``None``: zero events, zero allocations, no locks taken.  When armed,
events are appended to a bounded ring buffer (``deque(maxlen=...)``)
under one lock; when the buffer is full the *oldest* events are dropped
and counted in :attr:`Recorder.n_dropped`.

Events are stored directly in Chrome/Perfetto trace-event form
(``ph`` ∈ {X, i, C, b, e, M}; timestamps in microseconds relative to the
recorder's arm time) so export is a plain JSON dump — see
:mod:`repro_torch.obs.export`.

**Spans measure the host.**  The port launches its kernels
asynchronously, so a span around a model step (``engine.<name>``, cat
``kernel``) closes when the host has enqueued the step's work, not when
the device has run it; the device time lands in the first later span
that waits for a result (the sampler reading the logits).  This is the
JAX package's meaning too: its jitted steps dispatch asynchronously, and
its ``engine.*`` spans close before the engine reads the result on the
host.  No synchronisation is added when tracing is armed: a traced run
measures what an untraced run does.  While the host is the bottleneck
(every serving step of the port on the H100), the device finishes each
step's work within a fraction of a millisecond of the span's end, so the
span is the step's time.

Timestamps use ``time.monotonic`` by default, the same clock
``serve.server.ServeLoop`` and ``serve.metrics`` use, so span endpoints
and metrics histograms share a timebase.  Instrumentation that already
holds a clock value passes it explicitly (``rec.complete(name, t0, t1)``)
instead of re-reading the clock, keeping trace spans numerically equal
to the metrics they mirror.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Optional

__all__ = ["Recorder", "active", "span", "start", "stop", "tracing"]

_ACTIVE: Optional["Recorder"] = None  # the armed recorder; None == disabled

DEFAULT_MAX_EVENTS = 1 << 20


def active() -> Optional["Recorder"]:
    """The armed :class:`Recorder`, or ``None`` (the hot-path fast exit)."""
    return _ACTIVE


class Recorder:
    """Bounded, thread-safe ring buffer of Chrome trace events."""

    def __init__(
        self,
        max_events: int = DEFAULT_MAX_EVENTS,
        clock: Callable[[], float] = time.monotonic,
        meta: Optional[dict] = None,
    ):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.clock = clock
        self.t0 = clock()
        self.max_events = int(max_events)
        self.n_dropped = 0
        self.meta = dict(meta or {})
        self.pid = os.getpid()
        self._mu = threading.Lock()
        self._events: deque = deque(maxlen=self.max_events)
        self._named_tids: set = set()

    # -- time ----------------------------------------------------------

    def now(self) -> float:
        """Current clock value (seconds); pass back into the event APIs."""
        return self.clock()

    def to_us(self, t: float) -> float:
        """Clock seconds -> trace microseconds (relative to arm time)."""
        return (t - self.t0) * 1e6

    # -- event emission ------------------------------------------------

    def _append(self, ev: dict) -> None:
        with self._mu:
            tid = ev["tid"]
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self._push({
                    "name": "thread_name", "ph": "M", "ts": 0.0,
                    "pid": self.pid, "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            self._push(ev)

    def _push(self, ev: dict) -> None:
        if len(self._events) == self.max_events:
            self.n_dropped += 1  # deque(maxlen) drops the oldest silently
        self._events.append(ev)

    def _base(self, name: str, ph: str, ts: Optional[float], cat: str) -> dict:
        t = self.clock() if ts is None else ts
        return {
            "name": name, "cat": cat, "ph": ph, "ts": self.to_us(t),
            "pid": self.pid, "tid": threading.get_ident(),
        }

    def complete(
        self,
        name: str,
        t_start: float,
        t_end: Optional[float] = None,
        *,
        cat: str = "",
        args: Optional[dict] = None,
    ) -> None:
        """A closed span [t_start, t_end] (ph="X"). Times in clock seconds."""
        t1 = self.clock() if t_end is None else t_end
        ev = self._base(name, "X", t_start, cat)
        ev["dur"] = max(0.0, (t1 - t_start) * 1e6)
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(
        self,
        name: str,
        *,
        cat: str = "",
        args: Optional[dict] = None,
        ts: Optional[float] = None,
    ) -> None:
        """A point event (ph="i", thread-scoped)."""
        ev = self._base(name, "i", ts, cat)
        ev["s"] = "t"
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(
        self,
        name: str,
        value: float,
        *,
        cat: str = "",
        ts: Optional[float] = None,
    ) -> None:
        """A counter-track sample (ph="C")."""
        ev = self._base(name, "C", ts, cat)
        ev["args"] = {"value": value}
        self._append(ev)

    def async_begin(
        self,
        name: str,
        id: Any,
        *,
        cat: str = "",
        args: Optional[dict] = None,
        ts: Optional[float] = None,
    ) -> None:
        """Open an async span keyed by ``id`` (ph="b"); spans cross threads."""
        ev = self._base(name, "b", ts, cat)
        ev["id"] = str(id)
        if args:
            ev["args"] = args
        self._append(ev)

    def async_end(
        self,
        name: str,
        id: Any,
        *,
        cat: str = "",
        args: Optional[dict] = None,
        ts: Optional[float] = None,
    ) -> None:
        """Close the async span opened under the same ``name``/``id`` (ph="e")."""
        ev = self._base(name, "e", ts, cat)
        ev["id"] = str(id)
        if args:
            ev["args"] = args
        self._append(ev)

    # -- introspection -------------------------------------------------

    def events(self) -> list:
        """Snapshot of buffered events, oldest first."""
        with self._mu:
            return list(self._events)

    def __len__(self) -> int:
        with self._mu:
            return len(self._events)

    def clear(self) -> None:
        with self._mu:
            self._events.clear()
            self._named_tids.clear()
            self.n_dropped = 0


# -- arming ------------------------------------------------------------


def start(recorder: Optional[Recorder] = None, **kw) -> Recorder:
    """Arm ``recorder`` (or a fresh ``Recorder(**kw)``) as the global sink."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a trace Recorder is already armed; stop() it first")
    _ACTIVE = recorder if recorder is not None else Recorder(**kw)
    return _ACTIVE


def stop() -> Optional[Recorder]:
    """Disarm and return the active recorder (None if none was armed)."""
    global _ACTIVE
    rec, _ACTIVE = _ACTIVE, None
    return rec


@contextmanager
def tracing(recorder: Optional[Recorder] = None, **kw):
    """``with trace.tracing() as rec:`` — arm for the duration of the block."""
    rec = start(recorder, **kw)
    try:
        yield rec
    finally:
        stop()


@contextmanager
def span(name: str, *, cat: str = "", args: Optional[dict] = None):
    """Record a complete span around the block — convenience for warm paths.

    Hot paths should open-code the ``rec = active()`` check instead so the
    disabled path stays a single global read with no generator frame.
    """
    rec = _ACTIVE
    if rec is None:
        yield None
        return
    t0 = rec.clock()
    try:
        yield rec
    finally:
        rec.complete(name, t0, cat=cat, args=args)
