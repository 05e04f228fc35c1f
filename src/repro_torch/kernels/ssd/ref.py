"""Sequential-scan oracle for the SSD kernels (the JAX package's
``ssd_scan_ref``), one time step at a time in fp32."""
import torch


def ssd_scan_ref(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 log_a: torch.Tensor) -> torch.Tensor:
    """``H_t = exp(log_a_t) H_{t-1} + xdt_t (x) B_t``, ``y_t = C_t . H_t``.

    xdt (bsz, h, s, P); b, c (bsz, s, N) shared by the heads; log_a
    (bsz, h, s).  Returns y (bsz, h, s, P) fp32."""
    bsz, h, s, p = xdt.shape
    xdt, b, c, log_a = xdt.float(), b.float(), c.float(), log_a.float()
    state = xdt.new_zeros((bsz, h, p, b.shape[-1]))
    ys = []
    for t in range(s):
        state = torch.exp(log_a[:, :, t])[..., None, None] * state \
            + xdt[:, :, t, :, None] * b[:, None, t, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=2)
