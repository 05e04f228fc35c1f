"""Architecture registry of the port: ``get_config(arch_id)`` -> ModelConfig.

The port serves the dense decoder family; the registry holds the
architectures it has been held against the JAX package on.
"""
from __future__ import annotations

import importlib

ARCHS: tuple[str, ...] = ("qwen1.5-0.5b",)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


class DraftPairingError(ValueError):
    """A (target, draft) speculative-decoding pair failed validation."""


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, *, reduced: bool = False):
    """Load an architecture config; ``reduced=True`` returns the small
    same-family config used by the CPU tests."""
    mod = _module(arch)
    return mod.reduced_config() if reduced else mod.config()
