"""Kernels of the port: hand-written CUDA for Hopper, each with its plain
PyTorch version beside it, behind a schedule registry (see ``api.py``)."""
from repro_torch.kernels.api import (  # noqa: F401
    ACTIVATIONS,
    KERNELS,
    DispatchPolicy,
    get_policy,
    launch_counts,
    linear,
    op,
    reset_launch_counts,
    resolve,
    set_policy,
    use_policy,
)
