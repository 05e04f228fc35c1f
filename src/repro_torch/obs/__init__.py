"""Structured tracing with a near-zero-cost disabled path (torch-free)."""
from repro_torch.obs.trace import Recorder, active, span, start, stop, tracing

__all__ = ["Recorder", "active", "span", "start", "stop", "tracing"]
