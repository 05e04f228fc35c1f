"""Plain-PyTorch oracle for the flash-attention kernels (the JAX
package's ``attention_ref``): the scores and the PV product in the
inputs' dtype, the softmax in fp32, positions from 0 for both q and k."""
import math

import torch

NEG_INF = -(2.0**30)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, softcap: float | None = None) -> torch.Tensor:
    """q (b, h, sq, d); k/v (b, kvh, sk, d) -> (b, h, sq, d) in v's dtype."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
