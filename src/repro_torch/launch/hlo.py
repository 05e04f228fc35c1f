"""Step analysis: the port's counterpart of the JAX package's
``launch/hlo.py``.  Where JAX's reads the compiled HLO of a step, this
reads a *recorded* step: the step run once on ``meta`` tensors (shapes
and dtypes, no values, nothing allocated, compiled or launched) under
the ``reference`` kernel policy and :func:`record_step`'s recorders:

* dot FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` — every
  matmul, batched matmul and einsum, forward and backward, at
  2 x M x N x K, as HLO's ``dot`` count;
* collectives by the seam of :mod:`repro_torch.dist.tp`, under HLO's
  names, bytes as the result's shape on the rank (per device, as JAX's
  module is per device);
* ``result_bytes``: the bytes of every op's output that is a new tensor
  (not a view), forward and backward — JAX's write-traffic proxy counts
  top-level instructions only, after XLA's fusion, so this one is larger;
* the temporaries: the peak of the bytes of the live ``meta`` storages
  the step creates (its inputs not counted), by a ``TorchDispatchMode``
  of this module that keeps a weak reference to each new storage.

Loops the model runs on ``meta`` tensors as one iteration (``tp.repeat``:
the attention's and the cross entropy's chunk loops) count as often as
they would run, as HLO's analysis multiplies a ``while`` body by its trip
count.

:func:`memory_summary` gives JAX's ``argument_size_in_bytes``,
``output_size_in_bytes``, ``temp_size_in_bytes`` and the two per-device
megabyte figures; JAX's ``generated_code_size_in_bytes`` and
``alias_size_in_bytes`` have no counterpart (no code is generated, and
the step updates its parameters in place instead of aliasing donated
buffers).  :func:`cost_summary` gives ``flops`` (the dot FLOPs) and
``bytes_accessed`` (every non-view op's input and output bytes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.dist import tp


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Ops(TorchDispatchMode):
    """Every op's new outputs: their bytes, the bytes the op reads, and
    the live storages' peak."""

    SWEEP = 256  # ops between sweeps of the dead storages

    def __init__(self):
        super().__init__()
        self.result_bytes = 0
        self.bytes_accessed = 0
        self.live: dict[int, tuple[StorageWeakRef, int]] = {}
        self.live_bytes = self.peak = 0
        self._ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        new = 0
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            seen = self.live.get(ref.cdata)
            if seen is not None and not seen[0].expired():
                continue  # a view, or an in-place op's own storage
            if seen is not None:  # a dead storage's address, reused
                self.live_bytes -= seen[1]
            n = st.nbytes()
            self.live[ref.cdata] = (ref, n)
            self.live_bytes += n
            new += _nbytes(t)
        if new:
            self.result_bytes += new
            self.bytes_accessed += new + sum(_nbytes(a) for a in tree_leaves((args, kwargs))
                                             if isinstance(a, torch.Tensor))
        self.peak = max(self.peak, self.live_bytes)
        self._ops += 1
        if self._ops % self.SWEEP == 0:
            self.sweep()
        return out

    def sweep(self) -> None:
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.live_bytes -= self.live.pop(key)[1]

    def known(self, trees) -> None:
        """Count the storages of ``trees`` (the inputs) as not the step's."""
        for t in tree.leaves(trees):
            if isinstance(t, torch.Tensor):
                ref = StorageWeakRef(t.untyped_storage())
                self.live.setdefault(ref.cdata, (ref, 0))


class _Counts(tp.Recorder):
    """The seam's recorder, also scaling the FLOPs and bytes of a
    ``tp.repeat`` region."""

    def __init__(self, flops: FlopCounterMode, ops: _Ops):
        super().__init__()
        self.fc, self.ops, self.extra_flops = flops, ops, 0
        self._snaps: list[tuple[int, int, int]] = []

    def flops(self) -> int:
        return self.fc.get_total_flops() + self.extra_flops

    def begin_repeat(self) -> None:
        super().begin_repeat()
        self._snaps.append((self.flops(), self.ops.result_bytes, self.ops.bytes_accessed))

    def end_repeat(self, n: int) -> None:
        super().end_repeat(n)
        f0, r0, a0 = self._snaps.pop()
        self.extra_flops += (n - 1) * (self.flops() - f0)
        self.ops.result_bytes += (n - 1) * (self.ops.result_bytes - r0)
        self.ops.bytes_accessed += (n - 1) * (self.ops.bytes_accessed - a0)


@dataclasses.dataclass
class StepRecord:
    """What one recorded run of a step gives the analysis."""

    dot_flops: int
    collectives: list  # (op, axis, bytes, count, site)
    result_bytes: int
    bytes_accessed: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    trace_s: float
    #: the matmul problems the step dispatched, (M, K, N, dtype) -> calls
    #: (forward calls only: the reference policy differentiates through
    #: torch ops; a call inside a repeated loop counts once)
    matmuls: dict = dataclasses.field(default_factory=dict)


def _tree_bytes(trees) -> int:
    seen, total = set(), 0
    for t in tree.leaves(trees):
        if isinstance(t, torch.Tensor):
            key = StorageWeakRef(t.untyped_storage()).cdata
            if key not in seen:
                seen.add(key)
                total += _nbytes(t)
    return total


def record_step(fn, inputs: tuple) -> StepRecord:
    """Run ``fn(*inputs)`` once — every input a ``meta`` tensor, or a tree
    of them, or a plain number — under the ``reference`` policy and the
    recorders, and return what they saw."""
    from repro_torch import kernels
    from repro_torch.obs import trace

    bad = [t for t in tree.leaves(inputs) if isinstance(t, torch.Tensor) and not t.is_meta]
    if bad:
        raise ValueError("record_step runs on meta tensors only (it computes no values)")
    ops = _Ops()
    ops.known(inputs)
    fc = FlopCounterMode(display=False)
    counts = _Counts(fc, ops)
    spans = trace.Recorder(max_events=1 << 20) if trace.active() is None else None
    t0 = time.perf_counter()
    with kernels.use_policy("reference"), tp.recording(counts), \
            (trace.tracing(spans) if spans is not None else contextlib.nullcontext()), fc, ops:
        out = fn(*inputs)
    trace_s = time.perf_counter() - t0
    ops.sweep()
    matmuls: dict = {}
    for ev in spans.events() if spans is not None else ():
        if ev.get("name") == "dispatch.matmul":
            key = (*ev["args"]["shape"], ev["args"]["dtype"])
            matmuls[key] = matmuls.get(key, 0) + 1
    return StepRecord(dot_flops=int(counts.flops()), collectives=[list(e) for e in counts.events],
                      result_bytes=ops.result_bytes, bytes_accessed=ops.bytes_accessed,
                      argument_bytes=_tree_bytes(inputs), output_bytes=_tree_bytes(out),
                      temp_bytes=ops.peak, trace_s=trace_s, matmuls=matmuls)


def analyze_step(record: StepRecord, n_devices: int) -> dict:
    """JAX's ``analyze_compiled`` keys for a recorded step (per device).
    ``unknown_trip_whiles`` is 0: every repeated loop knows its count."""
    counts: dict[str, float] = {}
    by_op: dict[str, float] = {}
    for op, _axis, nbytes, count, _site in record.collectives:
        counts[op] = counts.get(op, 0.0) + count
        by_op[op] = by_op.get(op, 0.0) + nbytes
    total = float(sum(by_op.values()))
    return {"dot_flops": float(record.dot_flops), "collective_bytes": total,
            "collective_counts": counts, "collective_bytes_by_op": by_op,
            "result_bytes": float(record.result_bytes), "unknown_trip_whiles": 0,
            "n_devices": n_devices, "global_collective_bytes": total * n_devices}


def cost_summary(record: StepRecord) -> dict:
    return {"flops": float(record.dot_flops), "bytes_accessed": float(record.bytes_accessed)}


def memory_summary(record: StepRecord) -> dict:
    return {"argument_size_in_bytes": int(record.argument_bytes),
            "output_size_in_bytes": int(record.output_bytes),
            "temp_size_in_bytes": int(record.temp_bytes),
            "argument_mb_per_device": record.argument_bytes / 1e6,
            "temp_mb_per_device": record.temp_bytes / 1e6}


__all__ = ["StepRecord", "analyze_step", "cost_summary", "memory_summary", "record_step"]
