"""Offline trace analysis: the paper-shaped multicast-efficiency report.

A copy of the JAX package's ``obs/analyze.py`` (the same schema, keys
and CLI) over the port's traces.  It consumes a trace produced by
:mod:`repro_torch.obs.trace` (exported via :mod:`repro_torch.obs.export`)
and computes a flat, schema-validated report:

* **B-fetches avoided by supertile reuse** — from ``dispatch.matmul``
  spans: a schedule fetches each B block once per ``gm``-row group
  (else once per ``bm``-row block) instead of once per 64-row core tile,
  the unicast strawman (``UNICAST_ROW_TILE``), mirroring the HBM-traffic
  model of ``kernels/matmul/matmul.py``.  The port's spans carry the
  tile of the CUDA design that ran (``kernels/api.py``
  ``_record_dispatch``: K1's grouped raster, K4's clusters, the 128 x 128
  or 64-row tiles), so on the card the ``matmul_b_*`` keys describe the
  H100 kernels; the plain versions on the CPU record no tile, and a call
  then counts one fetch of the whole B, as the JAX package's spans do
  with the autotuner off.
* **Prefix pages multicast vs re-prefilled** — from ``prefix.match`` /
  ``prefix.unmatch`` / ``prefix.commit_broadcast`` instants; sums match
  the live ``PrefixCache`` counters exactly.
* **Broadcast fabric bytes per mode vs the unicast baseline** — from
  ``mcast.broadcast`` instants, which the sharded page pool
  (``num_shards > 1``) emits per page-chain broadcast; with one shard
  every ``broadcast_*`` key reads 0.
* **TTFT/ITL decomposition** — per-request ``request.queue_wait`` +
  ``request.prefill`` span durations (TTFT), ``decode.tick`` spans (ITL
  proxy) and ``token.emit`` lag instants (emit).  Percentiles run
  through the port's ``serve.metrics.StreamingHistogram`` so they are
  directly comparable to the serve-metrics snapshot.

CLI: ``python -m repro_torch.obs.analyze TRACE.json [--json REPORT.json]``
prints the report as a table and optionally writes the JSON.
"""
from __future__ import annotations

import json
import math
from collections import Counter, defaultdict
from typing import Union

from repro_torch.obs.export import load, validate_trace

__all__ = ["analyze", "validate_report", "REPORT_SCHEMA",
           "REPORT_DYNAMIC_PREFIXES", "REPORT_SCHEMA_VERSION"]

REPORT_SCHEMA_VERSION = 1

# The unicast baseline for supertile B-reuse: one B-block fetch per
# 64-row core tile (the smallest tiled `bm` in the JAX autotuner's
# candidates, kept as the strawman whatever the card's tiles), the
# "every core fetches its own copy" strawman the paper's crossbar
# replaces with one multicast fetch.
UNICAST_ROW_TILE = 64

_NUM = (int, float)

# fixed report surface: key -> required type(s)
REPORT_SCHEMA = {
    "schema_version": int,
    "n_events": int,
    "trace_dropped": int,
    # kernel layer
    "kernel_calls_total": int,
    "kernel_dispatch_total": int,
    "kernel_autotune_hits": int,
    "kernel_autotune_misses": int,
    "kernel_fallbacks": int,
    # supertile B-reuse (modeled HBM traffic, autotune units)
    "matmul_b_block_fetches": int,
    "matmul_b_block_fetches_unicast": int,
    "matmul_b_bytes_fetched": _NUM,
    "matmul_b_bytes_unicast": _NUM,
    "matmul_b_bytes_avoided": _NUM,
    "matmul_b_fetch_avoided_frac": _NUM,
    # prefix multicast
    "prefix_pages_multicast": int,
    "prefix_pages_broadcast": int,
    "prefix_hit_tokens": int,
    "prefix_miss_tokens": int,
    "prefix_pages_inserted": int,
    "prefix_pages_evicted": int,
    # cross-shard broadcast fabric accounting
    "broadcast_chains": int,
    "broadcast_pages": int,
    "broadcast_payload_bytes": _NUM,
    "broadcast_fabric_bytes": _NUM,
    "broadcast_unicast_bytes": _NUM,
    "broadcast_savings_frac": _NUM,
    # page pool
    "pool_pages_allocated": int,
    "pool_pages_freed": int,
    "pool_pages_shared": int,
    "pool_cow_copies": int,
    # pressure / degradation
    "preemptions": int,
    "swap_ins": int,
    "swap_lost": int,
    "quarantined_pages": int,
    "sched_evictions": int,
    "admission_rejections": int,
    "faults_fired_total": int,
    # speculative decoding (spec.verify instants from the engine)
    "spec_rounds": int,
    "spec_drafted": int,
    "spec_accepted": int,
    "spec_committed": int,
    "spec_rollback_pages": int,
    "spec_accept_rate": _NUM,
    # request lifecycle
    "requests_submitted": int,
    "requests_finished": int,
    "decode_ticks": int,
    "decode_tick_p50_ms": _NUM,
    "tokens_emitted": int,
    "emit_lag_p50_ms": _NUM,
    "queue_wait_p50_ms": _NUM,
    "prefill_p50_ms": _NUM,
    "ttft_decomposed_p50_ms": _NUM,
}

# dynamic key families (all numeric): per-kernel call counts, per-
# (op, schedule) dispatch counts, per-mode fabric bytes, per-site faults
REPORT_DYNAMIC_PREFIXES = (
    "kernel_calls_",
    "kernel_dispatch_",
    "broadcast_fabric_bytes_",
    "fault_fired_",
)


def validate_report(report: dict) -> dict:
    """Raise ``ValueError`` unless ``report`` matches the schema exactly."""
    if not isinstance(report, dict):
        raise ValueError("report must be a dict")
    missing = [k for k in REPORT_SCHEMA if k not in report]
    if missing:
        raise ValueError(f"report missing keys: {missing}")
    for k, v in report.items():
        if k in REPORT_SCHEMA:
            want = REPORT_SCHEMA[k]
            if not isinstance(v, want) or isinstance(v, bool):
                raise ValueError(f"report[{k!r}]={v!r}: wrong type")
        elif k.startswith(REPORT_DYNAMIC_PREFIXES):
            if not isinstance(v, _NUM) or isinstance(v, bool):
                raise ValueError(f"report[{k!r}]={v!r}: must be numeric")
        else:
            raise ValueError(f"report has unknown key {k!r}")
    for k, v in report.items():
        if isinstance(v, float) and not math.isfinite(v):
            raise ValueError(f"report[{k!r}]={v!r}: not finite")
    return report


def _p50_ms(values_s) -> float:
    """p50 of durations (seconds) in ms, via ``serve.metrics.StreamingHistogram``,
    so the estimate is bucket-for-bucket identical to the live snapshot.
    Imported here, not at the top: ``obs`` stays free of the serving
    package (and torch) at import time."""
    from repro_torch.serve.metrics import StreamingHistogram

    vals = list(values_s)
    if not vals:
        return 0.0
    h = StreamingHistogram()
    for v in vals:
        h.record(v)
    return h.percentile(50) * 1e3


_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "fp8": 1,
}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def analyze(trace: Union[dict, list, str]) -> dict:
    """Compute the efficiency report from a trace (dict, event list, or path)."""
    if isinstance(trace, str):
        trace = load(trace)
    if isinstance(trace, dict):
        events = trace.get("traceEvents", [])
        metadata = trace.get("metadata", {}) or {}
    else:
        events, metadata = list(trace), {}

    kernel_calls: Counter = Counter()
    dispatch: Counter = Counter()
    fabric_by_mode: Counter = Counter()
    faults: Counter = Counter()
    n = Counter()  # scalar accumulators
    acc = defaultdict(float)

    b_fetches = b_fetches_uni = 0
    b_bytes = b_bytes_uni = 0.0

    qw_by_rid: dict = {}
    pf_by_rid: dict = {}
    tick_durs: list = []
    emit_lags: list = []

    for ev in events:
        name, ph = ev.get("name", ""), ev.get("ph")
        args = ev.get("args", {}) or {}
        if ph == "X":
            if name.startswith("engine.") and ev.get("cat") == "kernel":
                kernel_calls[name[len("engine."):]] += 1
            elif name.startswith("dispatch."):
                n["dispatch_total"] += 1
                op = args.get("op", name[len("dispatch."):])
                sched = args.get("schedule", "unknown")
                dispatch[f"{op}_{sched}"] += 1
                if args.get("autotune_cached") is True:
                    n["autotune_hits"] += 1
                elif args.get("autotune_cached") is False:
                    n["autotune_misses"] += 1
                if op == "matmul" and len(args.get("shape", ())) == 3:
                    m, k, d_n = (int(x) for x in args["shape"])
                    dsize = _DTYPE_BYTES.get(args.get("dtype", ""), 2)
                    g = int(args.get("gm") or args.get("bm") or m)
                    bn = int(args.get("bn") or d_n)
                    bk = int(args.get("bk") or k)
                    nk_blocks = _cdiv(d_n, bn) * _cdiv(k, bk)
                    fetched = _cdiv(m, g) * nk_blocks
                    unicast = _cdiv(m, UNICAST_ROW_TILE) * nk_blocks
                    unicast = max(unicast, fetched)  # m < 64: no reuse possible
                    b_fetches += fetched
                    b_fetches_uni += unicast
                    b_bytes += k * d_n * dsize * _cdiv(m, g)
                    b_bytes_uni += k * d_n * dsize * max(
                        _cdiv(m, UNICAST_ROW_TILE), _cdiv(m, g))
            elif name == "request.queue_wait":
                qw_by_rid[args.get("rid")] = ev.get("dur", 0.0)
            elif name == "request.prefill":
                pf_by_rid[args.get("rid")] = ev.get("dur", 0.0)
            elif name == "decode.tick":
                n["decode_ticks"] += 1
                tick_durs.append(ev.get("dur", 0.0) / 1e6)
        elif ph == "i":
            if name == "pool.alloc":
                n["pool_alloc"] += int(args.get("n", 0))
            elif name == "pool.release":
                n["pool_freed"] += int(args.get("freed", 0))
            elif name == "pool.share":
                n["pool_shared"] += int(args.get("n", 0))
            elif name == "pool.cow":
                n["pool_cow"] += 1
            elif name == "prefix.match":
                n["prefix_pages"] += int(args.get("pages", 0))
                n["hit_tokens"] += int(args.get("hit_tokens", 0))
                n["miss_tokens"] += int(args.get("miss_tokens", 0))
            elif name == "prefix.unmatch":
                n["prefix_pages"] -= int(args.get("pages", 0))
                n["hit_tokens"] -= int(args.get("hit_tokens", 0))
                n["miss_tokens"] -= int(args.get("miss_tokens", 0))
                n["pool_shared"] -= int(args.get("pages", 0))
            elif name == "prefix.commit_broadcast":
                n["prefix_pages"] += int(args.get("pages", 0))
                n["prefix_broadcast"] += int(args.get("pages", 0))
                n["hit_tokens"] += int(args.get("tokens", 0))
                n["miss_tokens"] -= int(args.get("tokens", 0))
            elif name == "prefix.insert":
                n["prefix_inserted"] += int(args.get("pages", 0))
            elif name == "prefix.evict":
                n["prefix_evicted"] += int(args.get("pages", 0))
            elif name == "mcast.broadcast":
                n["bcast_chains"] += 1
                n["bcast_pages"] += int(args.get("pages", 0))
                acc["payload"] += float(args.get("payload_bytes", 0))
                acc["fabric"] += float(args.get("fabric_bytes", 0))
                acc["unicast"] += float(args.get("unicast_bytes", 0))
                fabric_by_mode[args.get("mode", "unknown")] += float(
                    args.get("fabric_bytes", 0))
            elif name == "engine.preempt":
                n["preempt"] += 1
            elif name == "engine.swap_in":
                n["swap_in"] += 1
            elif name == "engine.swap_lost":
                n["swap_lost"] += 1
            elif name == "engine.quarantine":
                n["quarantine"] += int(args.get("pages", 0))
            elif name == "sched.evict":
                n["sched_evict"] += 1
            elif name == "admission.backpressure":
                n["rejections"] += 1
            elif name == "kernel.fallback":
                n["fallbacks"] += 1
            elif name == "spec.verify":
                n["spec_rounds"] += 1
                n["spec_drafted"] += int(args.get("drafted", 0))
                n["spec_accepted"] += int(args.get("accepted", 0))
                n["spec_committed"] += int(args.get("committed", 0))
                n["spec_rollback_pages"] += int(args.get("rollback_pages", 0))
            elif name == "token.emit":
                n["tokens"] += 1
                emit_lags.append(float(args.get("lag_ms", 0.0)) / 1e3)
            elif name.startswith("fault."):
                faults[name[len("fault."):]] += 1
        elif ph == "b" and name == "request":
            n["submitted"] += 1
        elif ph == "e" and name == "request":
            n["finished"] += 1

    # TTFT decomposition: per-request queue-wait + prefill (both spans
    # share the admission timestamp, so their sum telescopes to
    # first_token_t - arrival_t — the exact value metrics.py records).
    ttft_s = [(qw_by_rid[r] + pf_by_rid[r]) / 1e6
              for r in qw_by_rid if r in pf_by_rid]

    report = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "n_events": len(events),
        "trace_dropped": int(metadata.get("n_dropped", 0)),
        "kernel_calls_total": sum(kernel_calls.values()),
        "kernel_dispatch_total": int(n["dispatch_total"]),
        "kernel_autotune_hits": int(n["autotune_hits"]),
        "kernel_autotune_misses": int(n["autotune_misses"]),
        "kernel_fallbacks": int(n["fallbacks"]),
        "matmul_b_block_fetches": int(b_fetches),
        "matmul_b_block_fetches_unicast": int(b_fetches_uni),
        "matmul_b_bytes_fetched": b_bytes,
        "matmul_b_bytes_unicast": b_bytes_uni,
        "matmul_b_bytes_avoided": b_bytes_uni - b_bytes,
        "matmul_b_fetch_avoided_frac":
            1.0 - b_bytes / b_bytes_uni if b_bytes_uni else 0.0,
        "prefix_pages_multicast": int(n["prefix_pages"]),
        "prefix_pages_broadcast": int(n["prefix_broadcast"]),
        "prefix_hit_tokens": int(n["hit_tokens"]),
        "prefix_miss_tokens": int(n["miss_tokens"]),
        "prefix_pages_inserted": int(n["prefix_inserted"]),
        "prefix_pages_evicted": int(n["prefix_evicted"]),
        "broadcast_chains": int(n["bcast_chains"]),
        "broadcast_pages": int(n["bcast_pages"]),
        "broadcast_payload_bytes": acc["payload"],
        "broadcast_fabric_bytes": acc["fabric"],
        "broadcast_unicast_bytes": acc["unicast"],
        "broadcast_savings_frac":
            1.0 - acc["fabric"] / acc["unicast"] if acc["unicast"] else 0.0,
        "pool_pages_allocated": int(n["pool_alloc"]),
        "pool_pages_freed": int(n["pool_freed"]),
        "pool_pages_shared": int(n["pool_shared"]),
        "pool_cow_copies": int(n["pool_cow"]),
        "preemptions": int(n["preempt"]),
        "swap_ins": int(n["swap_in"]),
        "swap_lost": int(n["swap_lost"]),
        "quarantined_pages": int(n["quarantine"]),
        "sched_evictions": int(n["sched_evict"]),
        "admission_rejections": int(n["rejections"]),
        "faults_fired_total": sum(faults.values()),
        "spec_rounds": int(n["spec_rounds"]),
        "spec_drafted": int(n["spec_drafted"]),
        "spec_accepted": int(n["spec_accepted"]),
        "spec_committed": int(n["spec_committed"]),
        "spec_rollback_pages": int(n["spec_rollback_pages"]),
        "spec_accept_rate":
            n["spec_accepted"] / n["spec_drafted"] if n["spec_drafted"]
            else 0.0,
        "requests_submitted": int(n["submitted"]),
        "requests_finished": int(n["finished"]),
        "decode_ticks": int(n["decode_ticks"]),
        "decode_tick_p50_ms": _p50_ms(tick_durs),
        "tokens_emitted": int(n["tokens"]),
        "emit_lag_p50_ms": _p50_ms(emit_lags),
        "queue_wait_p50_ms": _p50_ms(v / 1e6 for v in qw_by_rid.values()),
        "prefill_p50_ms": _p50_ms(v / 1e6 for v in pf_by_rid.values()),
        "ttft_decomposed_p50_ms": _p50_ms(ttft_s),
    }
    for name, c in sorted(kernel_calls.items()):
        report[f"kernel_calls_{name}"] = c
    for name, c in sorted(dispatch.items()):
        report[f"kernel_dispatch_{name}"] = c
    for mode, b in sorted(fabric_by_mode.items()):
        report[f"broadcast_fabric_bytes_{mode}"] = b
    for site, c in sorted(faults.items()):
        report[f"fault_fired_{site}"] = c
    return validate_report(report)


def format_report(report: dict) -> str:
    """Render the report as an aligned two-column table."""
    width = max(len(k) for k in report)
    lines = [f"{'metric':<{width}}  value", f"{'-' * width}  {'-' * 12}"]
    for k, v in report.items():
        if isinstance(v, float):
            v = f"{v:,.3f}"
        lines.append(f"{k:<{width}}  {v}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="Print the multicast-efficiency report for a trace.")
    ap.add_argument("trace", help="trace path (.json Chrome format or .jsonl)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the report as JSON to PATH")
    args = ap.parse_args(argv)

    report = analyze(validate_trace(load(args.trace)))
    print(format_report(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
