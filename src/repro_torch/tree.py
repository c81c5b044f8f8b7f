"""Nests of tensors: the one walker the port uses for them.

A nest is dicts, ordered dicts, lists, tuples and named tuples over leaves
(tensors, arrays, scalars); ``None`` holds no leaf. Leaves come in the
order the JAX package's pytrees and checkpoints use: a plain dict (or
defaultdict) by sorted key, an ordered dict in insertion order, sequences
and named tuples in order. Model parameters and caches, the checkpoint's
state and the converters all walk nests through this module, so the
leaves of one nest always pair with the leaves of another in the same
order.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Callable, Iterator, Optional

import torch

PyTree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[list]:
    """``node``'s children in leaf order, or ``None`` for a leaf."""
    if type(node) is OrderedDict:
        return list(node.values())
    if type(node) in (dict, defaultdict):
        return [node[k] for k in sorted(node)]
    if type(node) in (list, tuple) or _is_namedtuple(node):
        return list(node)
    return None


def _keys(node):
    """What a second nest must share with ``node`` to map beside it."""
    if isinstance(node, dict):
        return sorted(node)
    return len(node)


def _rebuild(node, kids: list, retype: Callable[[type], type]):
    """A node of ``node``'s kind over ``kids`` (given in leaf order)."""
    if type(node) is OrderedDict:
        return OrderedDict(zip(node.keys(), kids))
    if type(node) is dict:
        return dict(zip(sorted(node), kids))
    if type(node) is defaultdict:
        return defaultdict(node.default_factory, zip(sorted(node), kids))
    if _is_namedtuple(node):
        return retype(type(node))(*kids)
    return type(node)(kids)


def _same(cls: type) -> type:
    return cls


def tree_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(template: PyTree, leaves: Iterator) -> PyTree:
    """``template``'s nesting with its leaves drawn, in order, from
    ``leaves``."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return next(leaves)
    return _rebuild(template, [tree_unflatten(k, leaves) for k in kids],
                    _same)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree,
             retype: Callable[[type], type] = _same,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (nests of the same structure), keeping ``tree``'s nesting;
    each named tuple is rebuilt as ``retype`` of its class. A node of
    ``tree`` for which ``is_leaf`` holds is a leaf (``fn`` then gets the
    matching subtrees of ``rest``). Raises ``ValueError`` where a nest of
    ``rest`` differs from ``tree``."""
    if tree is None:
        return None
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(tree, *rest)
    rest_kids = [_children(r) for r in rest]
    for r, rk in zip(rest, rest_kids):
        if rk is None or _keys(r) != _keys(tree):
            raise ValueError(f"a nest of {type(r).__name__} does not match "
                             f"one of {type(tree).__name__}")
    return _rebuild(tree, [tree_map(fn, *ks, retype=retype, is_leaf=is_leaf)
                           for ks in zip(kids, *rest_kids)], retype)


def stack_trees(trees: list) -> PyTree:
    """One nest whose leaves stack the matching leaves of ``trees`` along a
    new leading axis (the reference's vmapped per-layer init)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)
