"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it (see ``api.py``)."""
from repro_torch.kernels.api import (  # noqa: F401
    ACTIVATIONS,
    KERNELS,
    launch_counts,
    linear,
    op,
    reset_launch_counts,
)
