"""Plain PyTorch oracle for the matmul kernels."""
import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32-accumulated matmul, output in a.dtype (matches the kernels)."""
    return (a.float() @ b.float()).to(a.dtype)
