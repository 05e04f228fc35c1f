"""Sequential-scan oracle for the RG-LRU kernels (the JAX package's
``rglru_scan_ref``): ``h_t = a_t h_{t-1} + b_t`` one step at a time."""
import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(batch, seq, d) decays and inputs -> h (batch, seq, d) in a's dtype,
    h_{-1} = 0.  Differentiable: autograd through it is the plain
    derivation of the recurrence's gradient."""
    state = a.new_zeros((a.shape[0], a.shape[2]))
    hs = []
    for t in range(a.shape[1]):
        state = a[:, t] * state + b[:, t]
        hs.append(state)
    return torch.stack(hs, dim=1)
