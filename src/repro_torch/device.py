"""Device selection shared by the port's entry points.

Every entry point (model init, page pools, the engine, the weight
converter, the launcher) runs on ``cuda`` unless the caller passes
``device="cpu"``.  Asking for CUDA on a machine without it is an error,
never a silent fall back to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device: str | torch.device = DEFAULT) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:  # name the card, so device comparisons hold
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
