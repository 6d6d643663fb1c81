"""Nested-container helpers for parameter and optimizer-state trees.

A tree is nested ``dict`` / ``list`` / ``tuple`` containers (``None`` is an
empty subtree) with anything else as its leaves, flattened in the
reference package's order: dict keys sorted, sequences in order. Leaf paths
are named as the reference names them (``['params']['w0']``, ``[0]``), so
checkpoints of either package carry the same names.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_path(tree, is_leaf: Callable | None = None) -> list:
    """``[(path, leaf), ...]`` in flatten order."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [("", tree)]
    out = []
    for key, sub in kids:
        out += [(key + path, leaf) for path, leaf in flatten_with_path(sub, is_leaf)]
    return out


def leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def unflatten_like(tree, new_leaves: list, is_leaf: Callable | None = None):
    """``tree``'s structure with ``new_leaves`` (flatten order) as leaves."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if not (is_leaf is not None and is_leaf(t)):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(f: Callable, tree, *rest, is_leaf: Callable | None = None) -> Any:
    """``f`` of the corresponding leaves of ``tree`` and ``rest`` (trees of
    ``tree``'s structure)."""
    cols = [leaves(tree, is_leaf)] + [leaves(r, is_leaf) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten_like(tree, [f(*xs) for xs in zip(*cols)], is_leaf)


def leaves_up_to(like, tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``like`` (``tree``
    has ``like``'s structure, with a subtree where ``like`` has a leaf),
    in ``like``'s flatten order."""
    if like is None:
        return []
    kids = _children(like)
    if kids is None:
        return [tree]
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in leaves_up_to(like[k], tree[k])]
    return [x for a, b in zip(like, tree) for x in leaves_up_to(a, b)]
