"""Parameter trees: nested dicts and lists of tensors (the shape of
``Layer.param_tree()``, which mirrors the JAX package's ``Model.params``
pytree). ``tree_map`` and ``tree_leaves`` visit dict entries in
insertion order and list entries in order, so a flat list of leaves
lines up with the tree it came from."""

from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over ``tree`` and the trees in ``rest``
    (same structure); returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
