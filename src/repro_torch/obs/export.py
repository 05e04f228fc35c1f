"""Chrome/Perfetto trace-event export + flat JSONL event log.

The :class:`~repro_torch.obs.trace.Recorder` already buffers events in Chrome
trace-event form, so export is an envelope + dump:

* ``write(rec, "trace.json")``  — ``{"traceEvents": [...], ...}``,
  loadable in https://ui.perfetto.dev or ``chrome://tracing``.
* ``write(rec, "trace.jsonl")`` — one event per line, for ``grep``/``jq``
  pipelines; :func:`load` reassembles the envelope.

:func:`validate_trace` is the schema gate CI runs on exported traces.
"""
from __future__ import annotations

import json
from typing import Any, Union

from repro_torch.obs.trace import Recorder

__all__ = ["to_chrome", "write", "write_chrome", "write_jsonl", "load",
           "validate_trace"]

TRACE_SCHEMA_VERSION = 1

# Chrome trace-event phases the recorder emits.
_PHASES = frozenset("XiCbeM")
# keys required on every event, with accepted types
_REQUIRED = {"name": str, "ph": str, "ts": (int, float), "pid": int,
             "tid": (int, str)}


def to_chrome(rec: Recorder) -> dict:
    """Envelope a recorder's buffer as a Chrome JSON-object-format trace."""
    return {
        "traceEvents": rec.events(),
        "displayTimeUnit": "ms",
        "metadata": {
            "schema_version": TRACE_SCHEMA_VERSION,
            "n_dropped": rec.n_dropped,
            **rec.meta,
        },
    }


def write_chrome(rec: Recorder, path: str) -> dict:
    trace = to_chrome(rec)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def write_jsonl(rec: Recorder, path: str) -> dict:
    """One JSON event per line; a leading ``metadata`` line keeps counts."""
    trace = to_chrome(rec)
    with open(path, "w") as f:
        f.write(json.dumps({"metadata": trace["metadata"]}) + "\n")
        for ev in trace["traceEvents"]:
            f.write(json.dumps(ev) + "\n")
    return trace


def write(rec: Recorder, path: str) -> dict:
    """Dispatch on extension: ``.jsonl`` -> event log, else Chrome JSON."""
    if path.endswith(".jsonl"):
        return write_jsonl(rec, path)
    return write_chrome(rec, path)


def load(path: str) -> dict:
    """Read back either export format as a ``{"traceEvents": ...}`` dict."""
    if path.endswith(".jsonl"):
        events, metadata = [], {}
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if "metadata" in row and "ph" not in row:
                    metadata = row["metadata"]
                else:
                    events.append(row)
        return {"traceEvents": events, "metadata": metadata}
    with open(path) as f:
        return json.load(f)


def validate_trace(trace: Union[dict, Any]) -> dict:
    """Raise ``ValueError`` unless ``trace`` is a well-formed event trace."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for key, types in _REQUIRED.items():
            if key not in ev:
                raise ValueError(f"event {i} ({ev.get('name')!r}): missing {key!r}")
            if not isinstance(ev[key], types):
                raise ValueError(
                    f"event {i} ({ev.get('name')!r}): {key}={ev[key]!r} has "
                    f"wrong type {type(ev[key]).__name__}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} ({ev['name']!r}): unknown phase {ph!r}")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"event {i} ({ev['name']!r}): X needs dur >= 0")
        if ph in ("b", "e") and "id" not in ev:
            raise ValueError(f"event {i} ({ev['name']!r}): async event needs id")
        if ph == "C":
            val = ev.get("args", {}).get("value")
            if not isinstance(val, (int, float)):
                raise ValueError(
                    f"event {i} ({ev['name']!r}): counter needs numeric "
                    f"args.value, got {val!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} ({ev['name']!r}): args must be a dict")
    return trace
