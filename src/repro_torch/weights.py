"""Convert a JAX parameter tree (dense, MoE, SSM or hybrid family) into the port's layout.

:func:`from_jax_params` takes the tree as nested dicts of numpy arrays
(``jax.device_get`` of ``repro.models.lm.init``'s output, or arrays
loaded from a checkpoint) and imports no JAX:

* bf16 arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``) cross into
  torch through a ``uint16`` view, since ``torch.from_numpy`` rejects
  that dtype;
* the stacked leaves of every stage (``stage{i}/b{j}``, leading axis =
  repeat) are split into one dict per layer under ``layers``, in the
  JAX order: stage by stage, repeat by repeat, block by block
  (``cfg.layer_defs``), whatever each stage's pattern (recurrentgemma's
  two stages differ); MoE leaves keep their expert axis, nested leaves
  (the SSD block's gated-norm ``scale``) their nesting, and every leaf
  its dtype (the fp32 ``a_log``, ``dt_bias``, ``d_skip`` and ``lam``);
* headed projections become 2-D: ``wq``/``wk``/``wv`` (d, heads,
  head_dim) -> (d, heads*head_dim), ``wo`` (heads, head_dim, d) ->
  (heads*head_dim, d), biases (heads, head_dim) -> (heads*head_dim,).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT, resolve


def to_torch(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> tensor on ``device``, bf16 through uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _layer(tree: dict, i: int, device) -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _layer(val, i, device)
            continue
        t = to_torch(val[i], device)
        if key in ("wq", "wk", "wv"):  # (d, heads, head_dim)
            t = t.reshape(t.shape[0], -1)
        elif key == "wo":  # (heads, head_dim, d)
            t = t.reshape(-1, t.shape[-1])
        elif key in ("bq", "bk", "bv"):  # (heads, head_dim)
            t = t.reshape(-1)
        out[key] = t.contiguous()
    return out


def from_jax_params(tree: dict, *, device: str | torch.device = DEFAULT) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's dict."""
    dev = resolve(device)
    layers = []
    for i in range(sum(k.startswith("stage") for k in tree)):
        stage = tree[f"stage{i}"]
        blocks = [stage[f"b{j}"] for j in range(len(stage))]
        repeats = len(next(iter(blocks[0]["norm1"].values())))
        layers += [_layer(block, r, dev) for r in range(repeats) for block in blocks]
    out = {
        "embed": {"table": to_torch(tree["embed"]["table"], dev)},
        "layers": layers,
        "final_norm": {"scale": to_torch(tree["final_norm"]["scale"], dev)},
    }
    if "unembed" in tree:
        out["unembed"] = {"w": to_torch(tree["unembed"]["w"], dev)}
    return out
