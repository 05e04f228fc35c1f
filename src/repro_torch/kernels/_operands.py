"""Operand checks the kernel wrappers share.

:func:`on_cpu` decides when a wrapper runs its plain version, and
:func:`check_fp32_operands` holds the scan kernels' operand rules.
"""
from __future__ import annotations

import torch


def on_cpu(*tensors) -> bool:
    """Every operand lies on the CPU: a wrapper then runs its plain version
    (and only then: any other device launches the kernel or raises)."""
    return all(t.device.type == "cpu" for t in tensors)


def check_fp32_operands(name: str, *tensors) -> torch.device:
    """The scan kernels' operand rules — one CUDA device, fp32, contiguous
    — or raise; returns the device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands must share one CUDA device, got "
                         f"{', '.join(str(t.device) for t in tensors)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the kernel takes fp32 operands, got "
                        f"{', '.join(str(t.dtype) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel reads contiguous tensors; got strides "
                         f"{[t.stride() for t in tensors]}")
    return dev
