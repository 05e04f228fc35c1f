"""The port's parameter trees: nested dicts, lists and tuples (NamedTuples
too) of tensors.  The JAX package walks its trees with ``jax.tree``; the
port's trees hold lists (one entry per layer), so it walks them here.

* :func:`leaves` — the leaves in the tree's own order: dict entries in
  insertion order, list and tuple items in index order;
* :func:`map_structure` — ``fn`` over the leaves of one or more trees of
  the same structure, the result in that structure;
* :func:`flatten_with_paths` — ``{"a/b/0/c": leaf}``, the leaf paths of
  the checkpoint format.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list[Any]:
    """Every leaf of ``tree``, in the tree's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_structure(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` for every leaf of ``tree``; ``rest``
    must have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_structure(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_structure(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def flatten_with_paths(tree, prefix: str = "") -> dict[str, Any]:
    """Every leaf under its path: dict keys, list and tuple indices and
    NamedTuple field names joined by ``/``, in the tree's order."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_with_paths(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(flatten_with_paths(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_with_paths(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


__all__ = ["flatten_with_paths", "leaves", "map_structure"]
