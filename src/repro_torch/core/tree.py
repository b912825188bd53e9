"""Nested-dict parameter trees (the port's stand-in for JAX pytrees).

Parameters are plain nested dicts whose leaves are tensors or
``QuantizedTensor``s (anything with ``.to`` and ``[i]``). Paths are the '/'-joined
dict keys, the same strings ``repro/core/treepath.py`` builds, so policy
decisions keyed on paths agree with the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.quant import QuantizedTensor


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


def tensor_items(tree, prefix: str = "", quant: bool = False) -> list[tuple[str, Any]]:
    """(path, tensor) for every stored tensor, in the reference's flatten
    order: dict keys sorted, NamedTuple fields (``AdamWState``) and a
    ``QuantizedTensor``'s ``qvalues`` and ``scales`` in their own order,
    as ``jax.tree_util.tree_flatten_with_path`` gives them (``quant``
    keeps QuantizedTensor leaves whole)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in tensor_items(tree[k], join(k), quant)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [it for k in tree._fields for it in tensor_items(getattr(tree, k), join(k), quant)]
    if isinstance(tree, QuantizedTensor) and not quant:
        return [(join("qvalues"), tree.qvalues), (join("scales"), tree.scales)]
    return [(prefix, tree)]


def tensor_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, tensor)`` over :func:`tensor_items`' tensors, in their
    order, rebuilding the tree (dicts, NamedTuples, QuantizedTensors)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        done = {k: tensor_map_with_path(fn, tree[k], join(k)) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tensor_map_with_path(fn, getattr(tree, k), join(k))
                            for k in tree._fields))
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(join("qvalues"), tree.qvalues), fn(join("scales"), tree.scales),
                               tree.group_size, tree.fmt)
    return fn(prefix, tree)


def tree_to(tree, device: torch.device):
    """Move every leaf to ``device`` (no copy for leaves already there)."""
    return tree_map(lambda leaf: leaf.to(device), tree)


def tree_index(tree, i: int):
    """Leaf-wise ``leaf[i]``: one layer's views out of stacked (L, ...) leaves."""
    return tree_map(lambda leaf: leaf[i], tree)

