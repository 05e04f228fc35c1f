"""Serving metrics: streaming latency histograms + one flat snapshot.

The server loop (:mod:`repro_torch.serve.server`) is judged by *traffic-shaped*
numbers — time-to-first-token, inter-token latency, sustained throughput,
batch occupancy — none of which exist at the engine level, where a
"step" has no arrival time.  This module owns that layer:

* :class:`StreamingHistogram` — geometric-bucket latency histogram:
  O(1) record, O(buckets) percentile estimate, no stored samples, so a
  long load run costs a fixed few KB however many tokens it emits.
* :class:`ServeMetrics` — per-request lifecycle timestamps (arrival,
  admission, first/last token), per-token gaps, per-tick batch
  occupancy, rejection/failure counters.
* :meth:`ServeMetrics.snapshot` — everything flattened into **one flat
  dict** (no nesting), merging the loop's own series with
  :meth:`repro_torch.serve.engine.PagedEngine.stats_delta` counters, the
  armed :class:`~repro_torch.serve.faults.FaultPlan`'s fired log, and the
  process-wide :class:`repro_torch.kernels.FallbackStats` — the single
  artifact a bench row, a CI assertion, or a dashboard scrapes.
* :func:`validate_snapshot` — the schema gate CI runs against the
  snapshot: fixed keys are type-checked, dynamic families are allowed
  only under known prefixes, anything else is an error (a typo'd or
  silently-dropped metric fails loudly).

Latencies are recorded in **seconds** (monotonic-clock deltas) and
reported in the snapshot as ``*_ms`` fields.  The snapshot's schema is
the JAX package's, key for key; the ``broadcast_*`` keys carry the
engine's page-chain broadcast counters (sharded pools, ``num_shards >
1``), 0 with one shard.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import Counter

# ---------------------------------------------------------------------------
# streaming histogram
# ---------------------------------------------------------------------------

class StreamingHistogram:
    """Geometric-bucket histogram over ``[lo, hi)`` with ``bins_per_decade``
    buckets per power of ten (~10% relative resolution at the default 24
    — plenty for p50/p99 of latencies that jitter more than that).

    ``record`` is O(1) and allocation-free; ``percentile`` interpolates
    within the winning bucket, clamped to the observed min/max so a
    one-sample histogram reports that sample, not a bucket edge.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 3600.0,
                 bins_per_decade: int = 24):
        self.lo = lo
        self.hi = hi
        self._log_lo = math.log(lo)
        self._scale = bins_per_decade / math.log(10.0)
        self.n_bins = int((math.log(hi) - self._log_lo) * self._scale) + 2
        self.counts = [0] * self.n_bins
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bin(self, x: float) -> int:
        if x < self.lo:
            return 0
        i = int((math.log(x) - self._log_lo) * self._scale) + 1
        return min(i, self.n_bins - 1)

    def _edge(self, i: int) -> float:
        """Upper edge of bucket ``i`` (bucket 0 is the [0, lo) underflow)."""
        if i <= 0:
            return self.lo
        return math.exp(self._log_lo + i / self._scale)

    def record(self, x: float) -> None:
        self.counts[self._bin(x)] += 1
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100].  Returns 0.0 on an empty histogram."""
        if not self.count:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= rank:
                # linear interpolation inside the bucket, clamped to the
                # true observed extremes
                frac = (rank - seen) / c
                lo_edge = self._edge(i - 1)
                est = lo_edge + frac * (self._edge(i) - lo_edge)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max


# ---------------------------------------------------------------------------
# per-request timelines + loop counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Timeline:
    """Monotonic timestamps for one request's lifecycle (seconds)."""

    arrival: float
    admitted: float | None = None
    first_token: float | None = None
    last_token: float | None = None
    n_tokens: int = 0
    final_state: str | None = None


class ServeMetrics:
    """Thread-safe collector the :class:`~repro_torch.serve.server.ServeLoop`
    workers feed; produces the flat snapshot described in the module
    docstring.  All ``t`` arguments are monotonic-clock seconds from the
    loop's single clock."""

    def __init__(self):
        self._mu = threading.Lock()
        self.timelines: dict[int, Timeline] = {}
        self.ttft = StreamingHistogram()          # arrival -> first token
        self.itl = StreamingHistogram()           # gap between tokens
        self.queue_wait = StreamingHistogram()    # arrival -> admission
        self.rejected: Counter[str] = Counter()   # typed rejection reasons
        self.states: Counter[str] = Counter()     # terminal state counts
        self.ticks = 0
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.prefills = 0
        self.prefills_mid_decode = 0              # admissions with >=1 live slot
        self.bucket_compiles = 0                  # distinct prefill buckets warmed
        self.t_first: float | None = None
        self.t_last: float | None = None

    # -- recording hooks ----------------------------------------------------
    def _touch(self, t: float) -> None:
        if self.t_first is None or t < self.t_first:
            self.t_first = t
        if self.t_last is None or t > self.t_last:
            self.t_last = t

    def record_arrival(self, rid: int, t: float) -> None:
        with self._mu:
            self.timelines[rid] = Timeline(arrival=t)
            self._touch(t)

    def record_admitted(self, rid: int, t: float, *, overlapped: bool) -> None:
        with self._mu:
            tl = self.timelines[rid]
            if tl.admitted is None:  # replays re-admit; keep the first
                tl.admitted = t
                self.queue_wait.record(t - tl.arrival)
            self.prefills += 1
            self.prefills_mid_decode += bool(overlapped)
            self._touch(t)

    def record_token(self, rid: int, t: float) -> None:
        with self._mu:
            tl = self.timelines[rid]
            if tl.first_token is None:
                tl.first_token = t
                self.ttft.record(t - tl.arrival)
            else:
                self.itl.record(t - tl.last_token)
            tl.last_token = t
            tl.n_tokens += 1
            self._touch(t)

    def record_done(self, rid: int, state: str) -> None:
        with self._mu:
            self.timelines[rid].final_state = state
            self.states[state] += 1

    def record_rejected(self, reason: str) -> None:
        with self._mu:
            self.rejected[reason] += 1

    def record_tick(self, n_slots: int) -> None:
        with self._mu:
            self.ticks += 1
            self.occupancy_sum += n_slots
            self.occupancy_max = max(self.occupancy_max, n_slots)

    def record_bucket_compile(self) -> None:
        with self._mu:
            self.bucket_compiles += 1

    # -- the flat snapshot --------------------------------------------------
    def snapshot(self, engine=None, fault_plan=None) -> dict:
        """One flat dict of the whole run.  ``engine`` merges
        ``engine.stats_delta()`` under ``engine_*`` keys (consuming the
        delta window), ``fault_plan`` merges the armed plan's fired log
        under ``fault_fired_*``; kernel fallback counters always ride
        along (zero when the fallback was never armed)."""
        from repro_torch import kernels  # local: serve must not import-cycle api

        with self._mu:
            tokens = sum(tl.n_tokens for tl in self.timelines.values())
            dur = (self.t_last - self.t_first) if (
                self.t_first is not None and self.t_last is not None
            ) else 0.0
            snap: dict = {
                "schema_version": 1,
                "requests_total": len(self.timelines),
                "requests_drained": self.states.get("DRAINED", 0),
                "requests_rejected": self.states.get("REJECTED", 0),
                "requests_failed": self.states.get("FAILED", 0),
                "tokens_out": tokens,
                "duration_s": dur,
                "sustained_tok_s": tokens / dur if dur > 0 else 0.0,
                "ttft_p50_ms": self.ttft.percentile(50) * 1e3,
                "ttft_p99_ms": self.ttft.percentile(99) * 1e3,
                "ttft_mean_ms": self.ttft.mean * 1e3,
                "itl_p50_ms": self.itl.percentile(50) * 1e3,
                "itl_p99_ms": self.itl.percentile(99) * 1e3,
                "itl_mean_ms": self.itl.mean * 1e3,
                "queue_wait_p50_ms": self.queue_wait.percentile(50) * 1e3,
                "queue_wait_p99_ms": self.queue_wait.percentile(99) * 1e3,
                "decode_ticks": self.ticks,
                "occupancy_mean": self.occupancy_sum / self.ticks
                if self.ticks else 0.0,
                "occupancy_max": self.occupancy_max,
                "prefills": self.prefills,
                "prefills_mid_decode": self.prefills_mid_decode,
                "bucket_compiles": self.bucket_compiles,
            }
            for reason, n in sorted(self.rejected.items()):
                snap[f"rejected_{reason}"] = n
        fb = kernels.fallback_stats()
        snap["kernel_fallback_calls"] = fb.calls
        snap["kernel_fallbacks"] = fb.fallbacks
        # mesh-sharding / page-broadcast surface: always present (the
        # single-host defaults when no engine rides along), cumulative
        # run totals — not deltas — so one snapshot answers "how much
        # fabric did broadcasts move" without windowing
        snap["num_shards"] = 1
        snap["mcast_mode"] = "unicast"
        snap["broadcast_chains"] = 0
        snap["broadcast_pages"] = 0
        snap["broadcast_payload_bytes"] = 0
        snap["broadcast_fabric_bytes"] = 0
        # speculative-decoding surface: same contract as the
        # broadcast family — always present, cumulative run totals; the
        # matching per-window deltas ride along as engine_spec_* via
        # stats_delta.  A speculative tick commits its whole accepted
        # burst with one timestamp, so intra-burst ITL gaps record as
        # ~0 — the stream truth, not an artifact.
        snap["spec_drafted"] = 0
        snap["spec_accepted"] = 0
        snap["spec_rollbacks"] = 0
        snap["accept_rate"] = 0.0
        if engine is not None:
            snap["num_shards"] = engine.num_shards
            snap["mcast_mode"] = engine.config.mcast_mode
            snap["broadcast_chains"] = engine.n_broadcast_chains
            snap["broadcast_pages"] = engine.n_broadcast_pages
            snap["broadcast_payload_bytes"] = engine.broadcast_payload_bytes
            snap["broadcast_fabric_bytes"] = engine.broadcast_fabric_bytes
            snap["spec_drafted"] = engine.n_spec_drafted
            snap["spec_accepted"] = engine.n_spec_accepted
            snap["spec_rollbacks"] = engine.n_spec_rollbacks
            snap["accept_rate"] = (
                engine.n_spec_accepted / max(1, engine.n_spec_drafted))
            for s in range(engine.num_shards):
                free = engine.pool.free_pages_on(s)
                snap[f"shard{s}_free_pages"] = free
                snap[f"shard{s}_in_use"] = engine.pool.pages_per_shard - free
            for k, v in engine.stats_delta().items():
                snap[f"engine_{k}"] = v
        if fault_plan is not None:
            for site, n in sorted(Counter(s for s, _ in fault_plan.fired).items()):
                snap[f"fault_fired_{site}"] = n
        return snap


# ---------------------------------------------------------------------------
# snapshot schema
# ---------------------------------------------------------------------------

_INT = int
_NUM = (int, float)
_STR = str

# fixed keys every snapshot must carry, with their required types
SNAPSHOT_SCHEMA: dict[str, type | tuple] = {
    "schema_version": _INT,
    "requests_total": _INT,
    "requests_drained": _INT,
    "requests_rejected": _INT,
    "requests_failed": _INT,
    "tokens_out": _INT,
    "duration_s": _NUM,
    "sustained_tok_s": _NUM,
    "ttft_p50_ms": _NUM,
    "ttft_p99_ms": _NUM,
    "ttft_mean_ms": _NUM,
    "itl_p50_ms": _NUM,
    "itl_p99_ms": _NUM,
    "itl_mean_ms": _NUM,
    "queue_wait_p50_ms": _NUM,
    "queue_wait_p99_ms": _NUM,
    "decode_ticks": _INT,
    "occupancy_mean": _NUM,
    "occupancy_max": _INT,
    "prefills": _INT,
    "prefills_mid_decode": _INT,
    "bucket_compiles": _INT,
    "kernel_fallback_calls": _INT,
    "kernel_fallbacks": _INT,
    "num_shards": _INT,
    "mcast_mode": _STR,
    "broadcast_chains": _INT,
    "broadcast_pages": _INT,
    "broadcast_payload_bytes": _NUM,
    "broadcast_fabric_bytes": _NUM,
    "spec_drafted": _INT,
    "spec_accepted": _INT,
    "spec_rollbacks": _INT,
    "accept_rate": _NUM,
}

# dynamic key families (per-reason / per-site / per-engine-counter /
# per-shard gauge) are allowed only under these prefixes — everything
# else is a schema error
SNAPSHOT_DYNAMIC_PREFIXES: dict[str, type | tuple] = {
    "rejected_": _INT,
    "engine_": _NUM,
    "fault_fired_": _INT,
    "shard": _NUM,
}


def validate_snapshot(snap: dict) -> dict:
    """Validate a :meth:`ServeMetrics.snapshot` dict against the schema;
    returns the snapshot (so call sites can chain) or raises
    ``ValueError`` naming every violation at once."""
    errors = []
    for key, typ in SNAPSHOT_SCHEMA.items():
        if key not in snap:
            errors.append(f"missing required key {key!r}")
        elif not isinstance(snap[key], typ) or isinstance(snap[key], bool):
            errors.append(
                f"{key!r} has type {type(snap[key]).__name__}, wanted {typ}"
            )
    for key, val in snap.items():
        if key in SNAPSHOT_SCHEMA:
            continue
        for prefix, typ in SNAPSHOT_DYNAMIC_PREFIXES.items():
            if key.startswith(prefix):
                if not isinstance(val, typ) or isinstance(val, bool):
                    errors.append(
                        f"{key!r} has type {type(val).__name__}, wanted {typ}"
                    )
                break
        else:
            errors.append(f"unknown key {key!r} (no matching dynamic prefix)")
    if errors:
        raise ValueError(
            "metrics snapshot failed schema validation:\n  "
            + "\n  ".join(errors)
        )
    return snap
