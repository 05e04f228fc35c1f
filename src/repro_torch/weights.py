"""Convert a JAX parameter tree of the dense family into the port's layout.

:func:`from_jax_params` takes the tree as nested dicts of numpy arrays
(``jax.device_get`` of ``repro.models.lm.init``'s output, or arrays
loaded from a checkpoint) and imports no JAX:

* bf16 arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``) cross into
  torch through a ``uint16`` view, since ``torch.from_numpy`` rejects
  that dtype;
* the stacked ``stage0`` leaves (leading axis = layer) are split into
  one dict per layer under ``layers``;
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
    """JAX dense-family parameter tree (numpy leaves) -> the port's dict."""
    dev = resolve(device)
    stages = [k for k in tree if k.startswith("stage")]
    if stages != ["stage0"] or set(tree["stage0"]) != {"b0"}:
        raise NotImplementedError(
            f"from_jax_params: expected one stage of one block (dense family), got "
            f"{sorted(stages)}")
    stacked = tree["stage0"]["b0"]
    n_layers = len(next(iter(stacked["norm1"].values())))
    out = {
        "embed": {"table": to_torch(tree["embed"]["table"], dev)},
        "layers": [_layer(stacked, i, dev) for i in range(n_layers)],
        "final_norm": {"scale": to_torch(tree["final_norm"]["scale"], dev)},
    }
    if "unembed" in tree:
        out["unembed"] = {"w": to_torch(tree["unembed"]["w"], dev)}
    return out
