"""Nested parameter trees (dicts and lists of tensors or arrays)."""

from __future__ import annotations


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
