"""Nested-container helpers for the port's parameter, centroid and cache
trees (dicts, lists and tuples of tensors — the JAX package's pytrees)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

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


def tree_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in `tree_map` order; a path is the tuple of list
    indices and dict keys down to the leaf."""
    if isinstance(tree, dict):
        return [pl for k in tree for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in tree_paths(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in `tree_map` order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with ``leaves`` (in `tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_reorder(tree: Any, like: Any) -> Any:
    """``tree`` with each dict's keys in ``like``'s order (lists and leaves
    as they are). Where the two disagree in structure ``tree`` comes back
    unchanged there, so the caller's own structure check reports it."""
    if (isinstance(tree, dict) and isinstance(like, dict)
            and tree.keys() == like.keys()):
        return {k: tree_reorder(tree[k], like[k]) for k in like}
    if (isinstance(tree, list) and isinstance(like, list)
            and len(tree) == len(like)):
        return [tree_reorder(t, x) for t, x in zip(tree, like)]
    return tree
