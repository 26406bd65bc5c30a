"""Nested containers of tensors (the port's pytrees): dicts, lists and
tuples, NamedTuples included, with tensors or other objects at the
leaves.  The reference walks its parameter, optimizer and checkpoint
trees with ``jax.tree``; the port walks them with these."""
from __future__ import annotations

from typing import Any, Callable, List, Optional


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _make(like, items):
    if isinstance(like, dict):
        return dict(zip(like.keys(), items))
    # a NamedTuple takes its fields positionally
    return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (which may stop at a leaf of ``tree``: an int8 moment's
    ``{"q", "s"}`` dict beside a parameter tensor)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    return _make(tree, [tree_map(fn, v, *(r[k] for r in rest),
                                 is_leaf=is_leaf) for k, v in kids])


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    """The leaves in order (dict insertion order, then list order)."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for _, v in kids for x in tree_leaves(v, is_leaf)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
