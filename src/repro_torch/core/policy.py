"""Post-training quantization policy (counterpart of ``repro/core/policy.py``).

The paper quantizes token embeddings, classifier, attention projections and
FFN matrices, and leaves RMSNorm weights in float (Table I). Leaves are
matched by their '/'-joined tree path exactly as in the reference, so the
same leaves are quantized with the same group sizes. Stacked layer leaves
(L, out, in) are quantized along the last axis.

On top of whether a leaf is quantized, the policy decides in which format:
leaves fall into layer classes (embed / classifier / attn / ffn / other)
and a format map gives each class a registry format. The "mixed" preset
keeps embeddings and classifier at int8 and packs attention/FFN to int4;
"mixed3" packs them to int3.

With the numerics checks on (``core/quant.py``, armed by a sanitized
engine before its PTQ) a corrupt weight raises ``QuantNumericsError``
naming its param path and layer class, as in the reference.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.core.quant import (
    QuantizedTensor,
    QuantNumericsError,
    _numerics_guard,
    get_format,
    largest_pow2_group,
    numerics_checks_enabled,
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

# Leaves whose contraction axis is sharded over the model axis when serving
# tensor-parallel (Megatron row-parallel, ``dist/sharding.ROW_PARALLEL``):
# their groups must fit within one shard, so the group size divides n/tp.
# MoE expert leaves are sharded on the expert axis; their contraction
# stays whole.
ROW_PARALLEL_KEYS = ("wo", "w2", "wout", "wff2")


def _row_parallel(path: str) -> bool:
    if "experts" in path:
        return False
    return path.rsplit("/", 1)[-1] in ROW_PARALLEL_KEYS

LEAF_CLASSES = ("embed", "classifier", "attn", "ffn", "other")
_FFN_LEAVES = ("w13", "w2", "wff1", "wff2", "wffr")
_ATTN_CONTAINERS = ("attn", "cross", "mamba")

# embeddings and classifier keep int8; the attention/FFN projections, the
# bulk of decode's weight bytes, drop to packed int4 ("mixed") or int3
MIXED_FORMAT_MAP: dict[str, str | None] = {
    "embed": "int8", "classifier": "int8", "attn": "int4", "ffn": "int4", "other": "int8"}
MIXED3_FORMAT_MAP: dict[str, str | None] = {
    "embed": "int8", "classifier": "int8", "attn": "int3", "ffn": "int3", "other": "int8"}
FORMAT_POLICIES: dict[str, Mapping[str, str | None]] = {
    "mixed": MIXED_FORMAT_MAP,
    "mixed3": MIXED3_FORMAT_MAP,
}


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


def resolve_format_map(formats) -> dict[str, str | None]:
    """A format selector -> a complete {layer class: format} map.

    ``formats`` is a registry format name (uniform), a preset of
    FORMAT_POLICIES, or a partial {class: name | None} map: classes left
    out get "int8" and an explicit None leaves that class in float."""
    if isinstance(formats, str):
        if formats in FORMAT_POLICIES:
            return dict(FORMAT_POLICIES[formats])
        get_format(formats)  # raises with the registered names on a typo
        return {c: formats for c in LEAF_CLASSES}
    if isinstance(formats, Mapping):
        bad = set(formats) - set(LEAF_CLASSES)
        if bad:
            raise ValueError(f"unknown layer classes {sorted(bad)}; valid: {LEAF_CLASSES}")
        out: dict[str, str | None] = {c: "int8" for c in LEAF_CLASSES}
        for cls, name in formats.items():
            if name is not None:
                get_format(name)
            out[cls] = name
        return out
    raise TypeError(f"formats must be a format/policy name or a {{class: format}} map, "
                    f"got {type(formats).__name__}")


def should_quantize(path: str, leaf: Any, group_size: int) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim < 2:
        return False
    if any(p in path for p in EXCLUDE_PATTERNS):
        return False
    n = leaf.shape[-1]
    return n % group_size == 0 and n >= MIN_QUANT_DIM


def leaf_group_size(path: str, leaf, preferred: int, tp: int = 1) -> int | None:
    """Per-leaf GS: the largest power of two <= ``preferred`` (and >= 16)
    dividing the per-shard contraction dim (n/tp for row-parallel leaves, n
    otherwise); None leaves the leaf in float, as does a row-parallel n
    that ``tp`` does not divide."""
    n = leaf.shape[-1]
    if _row_parallel(path):
        if n % tp:
            return None
        n //= tp
    return largest_pow2_group(n, preferred, min_gs=16)


def quantize_params(params, group_size: int, tp: int = 1, formats="int8"):
    """PTQ entry point: replace every quantizable weight leaf with a
    :class:`QuantizedTensor` (groups along the trailing/contraction axis) in
    the format its layer class maps to (``resolve_format_map``). ``tp`` is
    the serving mesh's tensor-parallel degree: it sizes each row-parallel
    leaf's groups so that none straddles a shard. A packed format whose
    pack factor does not divide the leaf's group size falls back to int8,
    never to float."""
    fmt_map = resolve_format_map(formats)

    def convert(path, leaf):
        p = path.lower()
        if not should_quantize(p, leaf, 16):
            return leaf
        fmt_name = fmt_map[leaf_class(p)]
        if fmt_name is None:
            return leaf
        gs = leaf_group_size(p, leaf, group_size, tp)
        if gs is None:
            return leaf
        fmt = get_format(fmt_name)
        if gs % fmt.pack:
            fmt = get_format("int8")  # packing impossible on this geometry
        try:
            return _quantize_stacked(fmt, leaf, gs)
        except QuantNumericsError as e:
            # repro-san attribution: which weight, which layer class
            raise QuantNumericsError(f"{e} [param {p!r}, layer-class {leaf_class(p)}]") from e

    return tree_map_with_path(convert, params)


def _quantize_stacked(fmt, leaf: torch.Tensor, gs: int) -> QuantizedTensor:
    """``fmt.quantize`` of a stacked (..., out, in) leaf one (out, in) slice
    at a time into the stacked storage: the same values (groups lie along
    each row), without the f32 copies of the whole leaf that one call makes
    (a layer of dbrx's experts is 2.1 G weights); a meta leaf (shapes only,
    ``models/registry.param_struct``) takes the one call. The numerics checks
    guard the whole leaf's input and scales, as the reference's one call
    does, so a fault is reported at the same index."""
    if leaf.ndim <= 2 or leaf.is_meta:
        return fmt.quantize(leaf, gs)
    check = numerics_checks_enabled()
    if check:
        _numerics_guard(f"quantize[{fmt.name}].input", leaf)
    flat = leaf.reshape(-1, *leaf.shape[-2:])
    first = fmt.quantize_fn(flat[0], group_size=gs)
    qv = first.qvalues.new_empty((flat.shape[0], *first.qvalues.shape))
    sc = first.scales.new_empty((flat.shape[0], *first.scales.shape))
    qv[0], sc[0] = first.qvalues, first.scales
    for i in range(1, flat.shape[0]):
        one = fmt.quantize_fn(flat[i], group_size=gs)
        qv[i], sc[i] = one.qvalues, one.scales
    lead = leaf.shape[:-2]
    qt = QuantizedTensor(qv.reshape(*lead, *qv.shape[1:]), sc.reshape(*lead, *sc.shape[1:]),
                         gs, fmt.name)
    if check:
        _numerics_guard(f"quantize[{fmt.name}].scales", qt.scales)
    return qt


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


def format_breakdown(params) -> dict[str, int]:
    """Stored bytes per quantization format, plus 'float' for the rest."""
    out: dict[str, int] = {}
    for leaf in tree_leaves(params):
        if isinstance(leaf, QuantizedTensor):
            out[leaf.fmt] = out.get(leaf.fmt, 0) + leaf.nbytes()
        else:
            out["float"] = out.get("float", 0) + leaf.numel() * leaf.element_size()
    return out
