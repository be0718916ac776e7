"""Nested-container helpers for the port's parameter, centroid and cache
trees (dicts, lists and tuples of tensors — the JAX package's pytrees)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_index(tree: Any, i: int) -> Any:
    """Row ``i`` of every leaf's leading (scan-group) axis."""
    return tree_map(lambda x: x[i], tree)


def tree_stack(trees: List[Any]) -> Any:
    """Stack same-structure trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])



def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in `tree_map` order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with ``leaves`` (in `tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
