"""Parameter specification trees — the one description of every parameter.

Each module describes its parameters as a nested dict of
:class:`ParamSpec` leaves (shape, dtype, initialiser).  From one tree the
port derives real parameters (:func:`init_params`) and parameter counts
(:func:`tree_params`), so the model functions, the weight converter and
the tests agree on every shape.

Projection weights are stored 2-D, in the layout ``kernels.linear``
contracts: ``(d_in, d_out)``.  Weights are bf16, norm scales fp32.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import torch

SpecTree = dict  # nested dict[str, "ParamSpec" | SpecTree | list]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "fan_in"  # fan_in | normal | zeros | ones
    scale: float = 1.0  # stddev multiplier


def _leaves(tree, prefix=()):
    if isinstance(tree, ParamSpec):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:  # list of per-layer trees
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))


def _materialise(spec: ParamSpec, path: str, seed: int, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        std = spec.scale
    elif spec.init == "fan_in":
        std = spec.scale / math.sqrt(max(spec.shape[0] if spec.shape else 1, 1))
    else:
        raise ValueError(f"unknown init: {spec.init}")
    # one generator per leaf, seeded from (seed, path): a leaf's values do
    # not depend on the order or number of the other leaves
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + zlib.crc32(path.encode())) & 0x7FFF_FFFF_FFFF)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(spec.dtype)


def init_params(spec_tree: SpecTree, *, seed: int, device) -> SpecTree:
    """Materialise real parameters on ``device`` from ``seed``."""
    def build(tree, prefix):
        if isinstance(tree, ParamSpec):
            return _materialise(tree, "/".join(prefix), seed, device)
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        return [build(v, prefix + (str(i),)) for i, v in enumerate(tree)]

    return build(spec_tree, ())


def tree_params(spec_tree: SpecTree) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(spec_tree))
