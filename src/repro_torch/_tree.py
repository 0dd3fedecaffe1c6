"""Minimal pytree helpers over nested dicts, lists, tuples and NamedTuples
(parameter trees, packed trees and lane-state lists)."""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable | None = None) -> Any:
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``, which share its structure), keeping the structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(tree, *rest)


def tree_leaves(tree: Any, is_leaf: Callable | None = None) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out
