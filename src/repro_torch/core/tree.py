"""Nested-dict parameter trees (the port's stand-in for JAX pytrees).

Parameters are plain nested dicts whose leaves are tensors or
``QuantizedTensor``s (anything with ``.to`` and ``[i]``). Paths are the '/'-joined
dict keys, the same strings ``repro/core/treepath.py`` builds, so policy
decisions keyed on paths agree with the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_items(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flatten order: a dict's keys
    sorted at every level, as ``jax.tree.leaves`` orders them (a sum over
    leaves then adds in the reference's order)."""
    if isinstance(tree, dict):
        out: list = []
        for k in sorted(tree):
            out += tree_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def tree_to(tree, device: torch.device):
    """Move every leaf to ``device`` (no copy for leaves already there)."""
    return tree_map(lambda leaf: leaf.to(device), tree)


def tree_index(tree, i: int):
    """Leaf-wise ``leaf[i]``: one layer's views out of stacked (L, ...) leaves."""
    return tree_map(lambda leaf: leaf[i], tree)

