"""Post-training quantization policy (counterpart of ``repro/core/policy.py``).

The paper quantizes token embeddings, classifier, attention projections and
FFN matrices, and leaves RMSNorm weights in float (Table I). Leaves are
matched by their '/'-joined tree path exactly as in the reference, so the
same leaves are quantized with the same group sizes. Stacked layer leaves
(L, out, in) are quantized along the last axis. Only the uniform ``int8``
format is ported; the reference's int4/int3/fp8 formats and mixed presets
raise "not yet ported".
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.quant import (
    QuantizedTensor,
    largest_pow2_group,
    quantize,
)
from repro_torch.core.tree import tree_leaves, tree_map_with_path

EXCLUDE_PATTERNS = (
    "norm",
    "router",
    "a_log", "dt_bias", "d_skip",
    "conv",
    "decay", "bonus", "mix", "lora",
    "bias",
)

MIN_QUANT_DIM = 32  # don't quantize anything smaller than one group

LEAF_CLASSES = ("embed", "classifier", "attn", "ffn", "other")
_FFN_LEAVES = ("w13", "w2", "wff1", "wff2", "wffr")
_ATTN_CONTAINERS = ("attn", "cross", "mamba")


def leaf_class(path: str) -> str:
    """Bucket a '/'-joined parameter path into one of LEAF_CLASSES."""
    parts = [p for p in path.lower().split("/") if p]
    if parts and parts[-1] in ("qvalues", "scales"):
        parts = parts[:-1]
    leaf = parts[-1] if parts else ""
    if "embed" in leaf:
        return "embed"
    if leaf == "classifier":
        return "classifier"
    if "mlp" in parts or "experts" in parts or leaf in _FFN_LEAVES:
        return "ffn"
    if any(c in parts for c in _ATTN_CONTAINERS) or leaf.startswith("w"):
        return "attn"
    return "other"


def should_quantize(path: str, leaf: Any, group_size: int) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim < 2:
        return False
    if any(p in path for p in EXCLUDE_PATTERNS):
        return False
    n = leaf.shape[-1]
    return n % group_size == 0 and n >= MIN_QUANT_DIM


def leaf_group_size(path: str, leaf, preferred: int) -> int | None:
    """Per-leaf GS: the largest power of two <= ``preferred`` (and >= 16)
    dividing the contraction dim; None leaves the leaf in float. (The
    reference also divides row-parallel leaves by a tensor-parallel degree;
    sharding is not ported.)"""
    return largest_pow2_group(leaf.shape[-1], preferred, min_gs=16)


def quantize_params(params, group_size: int, formats="int8"):
    """PTQ entry point: replace every quantizable weight leaf with an int8
    :class:`QuantizedTensor` (groups along the trailing/contraction axis)."""
    if formats != "int8":
        raise NotImplementedError(
            f"quantize formats {formats!r} are not yet ported to repro_torch; "
            "only the uniform 'int8' (paper W8A8) is")

    def convert(path, leaf):
        p = path.lower()
        if not should_quantize(p, leaf, 16):
            return leaf
        gs = leaf_group_size(p, leaf, group_size)
        if gs is None:
            return leaf
        return quantize(leaf, gs, "int8")

    return tree_map_with_path(convert, params)


def quantized_fraction(params) -> float:
    """Fraction of parameter bytes stored quantized after PTQ."""
    q_bits = tot_bits = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, QuantizedTensor):
            b = leaf.storage_bits()
            q_bits += b
            tot_bits += b
        else:
            tot_bits += leaf.numel() * leaf.element_size() * 8
    return q_bits / max(tot_bits, 1)
