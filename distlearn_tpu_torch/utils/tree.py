"""Minimal pytree walks over nested dicts, lists and tuples of tensors.

Dict keys are visited in sorted order, as ``jax.tree_util`` does, so a
parameter tree flattens to the same leaf order in both packages and the
flat buckets of :mod:`distlearn_tpu_torch.ops.flatten` line up.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

PyTree = Any


class TreeDef(NamedTuple):
    kind: Any                  # dict | list | tuple | a NamedTuple class | None (leaf)
    keys: tuple = ()           # sorted dict keys
    children: tuple = ()       # child TreeDefs


_LEAF = TreeDef(None)


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    leaves: list = []

    def _walk(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return TreeDef(dict, keys, tuple(_walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = type(t) if hasattr(t, "_fields") else (
                list if isinstance(t, list) else tuple)
            return TreeDef(kind, (), tuple(_walk(c) for c in t))
        leaves.append(t)
        return _LEAF

    return leaves, _walk(tree)


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)

    def _build(d: TreeDef):
        if d.kind is None:
            return next(it)
        kids = [_build(c) for c in d.children]
        if d.kind is dict:
            return dict(zip(d.keys, kids))
        if hasattr(d.kind, "_fields"):
            return d.kind(*kids)
        return d.kind(kids)

    return _build(treedef)


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
