"""Structured tracing, Perfetto export, and offline efficiency analysis.

``obs`` is stdlib-only at import time (no torch, no serve imports), so
every hot module — ``serve/pagepool.py``, ``kernels/api.py``,
``serve/faults.py`` — can import :mod:`repro_torch.obs.trace` without
cost or cycles.  The disabled path is one module-global read (the same
pattern as ``faults.fires``): ``trace.active()`` returns ``None`` unless
a :class:`~repro_torch.obs.trace.Recorder` has been armed.
:mod:`~repro_torch.obs.export` writes a recorder as a Chrome/Perfetto
trace and :mod:`~repro_torch.obs.analyze` turns a trace into the
multicast-efficiency report (``python -m repro_torch.obs.analyze``).
"""
from repro_torch.obs.trace import Recorder, active, span, start, stop, tracing

__all__ = [
    "Recorder",
    "active",
    "span",
    "start",
    "stop",
    "tracing",
]
