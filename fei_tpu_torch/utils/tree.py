"""Nested dicts of tensors (the parameter tree, the optimizer's moments):
flatten to path -> leaf and back, and map a function over the leaves."""

from __future__ import annotations

SEP = "/"


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"a": {"b": x}} -> {"a/b": x}``; anything that is not a dict is a leaf."""
    out = {}
    for key, node in tree.items():
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(node, dict):
            out.update(flatten(node, path))
        else:
            out[path] = node
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split(SEP)
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn(leaf, *other_leaves)`` over trees of one structure."""
    return {
        key: tree_map(fn, node, *(r[key] for r in rest)) if isinstance(node, dict)
        else fn(node, *(r[key] for r in rest))
        for key, node in tree.items()
    }
