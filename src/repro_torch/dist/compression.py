"""int8 block quantisation with error feedback for cross-pod gradients:
the port of the JAX package's ``dist/compression.py``.

Per 256-element block of the flattened leaf: scale = max|g|,
q = round(g / scale * 127).  The quantisation residual is carried in an
fp32 error-feedback state and added back the next step, so the running
sum of compressed gradients is unbiased (the EF-SGD argument).
``compress_grads`` returns dequantised gradients in the original dtype;
this module models the wire format's numerics.  The operations run in
JAX's order (``blocks / safe * 127``, round half to even, clip, then
``q * scale / 127``), each in fp32, so the results are bit-equal to
JAX's.  Blocks run over the *full* leaf: a shard of it would cut other
blocks, so a sharded step compresses after the gradients are reduced.
"""
from __future__ import annotations

import torch

from repro_torch import tree

BLOCK = 256


def init_error_state(grads_like):
    """fp32 zeros shaped like the gradient tree."""
    return tree.map_structure(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), grads_like)


def _quantise(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + err
    flat = gf.reshape(-1)
    n = flat.numel()
    pad = -n % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / safe * 127.0), -127, 127).to(torch.int8)
    deq = q.float() * scale / 127.0
    deq = deq.reshape(-1)[:n].reshape(g.shape)
    return deq.to(g.dtype), gf - deq


def compress_grads(grads, err_state):
    """Returns (compressed grads, new error state)."""
    pairs = [_quantise(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err_state))]
    gq, errs = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree.map_structure(lambda _: next(gq), grads),
            tree.map_structure(lambda _: next(errs), grads))


__all__ = ["BLOCK", "compress_grads", "init_error_state"]
