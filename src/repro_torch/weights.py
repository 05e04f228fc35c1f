"""Convert a JAX parameter tree into the port's layout: every family of
``models/lm.py`` (:func:`from_jax_params`) and the encoder-decoder of
``models/encdec.py`` (:func:`from_jax_encdec_params`).

Both take the tree as nested dicts of numpy arrays (``jax.device_get`` of
the JAX package's ``init`` output, or arrays loaded from a checkpoint)
and import no JAX:

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
  (heads*head_dim, d), biases (heads, head_dim) -> (heads*head_dim,);
* the leaves outside the stacks (``embed``, ``pos``, ``frontend_proj``,
  ``final_norm`` with layernorm's ``bias``, ``unembed``) keep their
  nesting; the encoder-decoder's ``encoder.stage`` and ``decoder.stage``
  stacks become the per-layer lists ``encoder.layers`` and
  ``decoder.layers`` (``self_attn`` and ``cross_attn`` made 2-D as above).
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


def _tree(tree: dict, device) -> dict:
    return {k: _tree(v, device) if isinstance(v, dict) else to_torch(v, device)
            for k, v in tree.items()}


def _repeats(block: dict) -> int:
    return len(next(iter(block["norm1"].values())))


def from_jax_params(tree: dict, *, device: str | torch.device = DEFAULT) -> dict:
    """JAX ``models/lm.py`` parameter tree (numpy leaves) -> the port's dict."""
    dev = resolve(device)
    layers = []
    for i in range(sum(k.startswith("stage") for k in tree)):
        stage = tree[f"stage{i}"]
        blocks = [stage[f"b{j}"] for j in range(len(stage))]
        layers += [_layer(block, r, dev) for r in range(_repeats(blocks[0])) for block in blocks]
    out = {k: _tree(v, dev) for k, v in tree.items() if not k.startswith("stage")}
    out["layers"] = layers
    return out


def from_jax_encdec_params(tree: dict, *, device: str | torch.device = DEFAULT) -> dict:
    """JAX ``models/encdec.py`` parameter tree (numpy leaves) -> the port's
    dict."""
    dev = resolve(device)
    out = {}
    for side in ("encoder", "decoder"):
        part = tree[side]
        out[side] = {k: _tree(v, dev) for k, v in part.items() if k != "stage"}
        out[side]["layers"] = [_layer(part["stage"], r, dev)
                               for r in range(_repeats(part["stage"]))]
    return out
