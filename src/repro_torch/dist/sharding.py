"""Placement policy: tree paths + shapes -> placement specs (counterpart of
``repro/dist/sharding.py``), and their DTensor placements.

A spec is a tuple with one entry a tensor dimension, each entry what the
reference's ``PartitionSpec`` holds there: None (unsharded), a mesh axis
name, or a tuple of names (one dimension split over several axes, the
first outermost). The rules are the reference's, written against the axis
names "data", "model" and an optional leading "pod", never device counts:

  column-parallel (wqkv, w13, wq, ...; (..., out, in))
        out -> model; in -> data (FSDP, train only)
  row-parallel (wo, w2, wout, wff2)
        in -> model; out -> data (train only)
  MoE experts (path contains "experts"; (..., E, out, in))
        E -> model; the within-expert contraction is never sharded, so
        quantization groups stay whole; FSDP still applies
  quantized leaves (qvalues / scales under a weight)
        qvalues take the weight's rule on their storage shape; scales take
        it except on the trailing group axis, which follows "model" only
        where the contraction does (row-parallel serve) and never takes
        FSDP: a group is never split across shards (``core/policy.py``
        sizes row-parallel groups to n/tp for this)
  embed: vocab -> model, d_model -> data (train only); norms, routers,
  SSM scan params, conv kernels, token-shift mixes, biases: replicated.

An axis that does not divide its dimension is dropped (unsharded), so
reduced configs and odd dims place everywhere.

On a ``DeviceMesh``, ``placements`` turns a spec into DTensor placements
(``Shard(d)`` on each mesh dimension that splits tensor dim d, in mesh
order, else ``Replicate()``); ``distribute`` places a tree (each rank keeps
its own block, cut from the full tensor it holds: no communication) and
``gather`` gives the full tensors back (``full_tensor()``, a collective:
every rank calls it on the same leaves in ``tensor_items`` order).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.quant import QuantizedTensor, get_format
from repro_torch.core.tree import tensor_items, tensor_map_with_path
from repro_torch.dist.logical import axis_names, axis_sizes

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Weights whose contraction (trailing) axis is model-sharded when serving;
# shared with the quantization group-size policy (core/policy.py).
ROW_PARALLEL = ("wo", "w2", "wout", "wff2")

# Leaf-name fragments that are always replicated (norms and the paper's
# small/accuracy-critical class; policy.EXCLUDE_PATTERNS).
REPLICATED = ("norm", "router", "a_log", "dt_bias", "d_skip", "conv",
              "decay", "bonus", "mix", "bias", "lora")

QUANT_LEAVES = ("qvalues", "scales")

Spec = tuple[Any, ...]


def _fit(dim: int, axis: str | None, sizes: dict[str, int]) -> str | None:
    """axis if it exists, is >1-way, and divides dim; else None."""
    if axis is None:
        return None
    n = sizes.get(axis, 1)
    return axis if n > 1 and dim % n == 0 else None


def dp_axes(mesh) -> tuple[str, ...]:
    """All data-parallel-like axes (everything except the model axis)."""
    return tuple(a for a in axis_names(mesh) if a != MODEL_AXIS)


def _entry(axes: tuple[str, ...]):
    """A spec entry over ``axes``: the name itself for one axis (as a
    ``PartitionSpec`` normalizes it), the tuple for several."""
    return axes[0] if len(axes) == 1 else axes


def _dp_size(mesh) -> int:
    s = axis_sizes(mesh)
    return int(math.prod(s[a] for a in dp_axes(mesh)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(path: str, shape, *, mesh, mode: str = "train") -> Spec:
    """Spec of one parameter leaf: ``path`` the '/'-joined tree path,
    ``shape`` the leaf's (storage) shape, ``mode`` "train" (adds FSDP over
    the data axis) or "serve"."""
    sizes = axis_sizes(mesh)
    parts = [p for p in str(path).split("/") if p]
    leaf = parts[-1].lower() if parts else ""
    quant_leaf = leaf if leaf in QUANT_LEAVES else None
    name = (parts[-2].lower() if len(parts) >= 2 else "") if quant_leaf else leaf
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    train = mode == "train"

    if ndim < 2 or any(pat in name for pat in REPLICATED):
        return tuple(spec)

    if name == "embed":
        spec[-2] = _fit(shape[-2], MODEL_AXIS, sizes)
        if quant_leaf != "scales":  # a quantized embed's group axis stays whole
            spec[-1] = _fit(shape[-1], DATA_AXIS if train else None, sizes)
        return tuple(spec)

    if name in ROW_PARALLEL:
        out_ax: str | None = DATA_AXIS if train else None
        in_ax: str | None = MODEL_AXIS
    else:  # column-parallel for every other large (..., out, in) matrix
        out_ax = MODEL_AXIS
        in_ax = DATA_AXIS if train else None

    if "experts" in parts:
        # expert-parallel: the stacked E axis takes the model axis, the
        # per-expert matmul axes may not reuse it
        out_ax = None if out_ax == MODEL_AXIS else out_ax
        in_ax = None if in_ax == MODEL_AXIS else in_ax
        if ndim >= 3:
            spec[ndim - 3] = _fit(shape[ndim - 3], MODEL_AXIS, sizes)

    spec[-2] = _fit(shape[-2], out_ax, sizes)
    if quant_leaf == "scales":
        # the trailing axis is the group axis: model-follow only, no FSDP
        spec[-1] = _fit(shape[-1], in_ax if in_ax == MODEL_AXIS else None, sizes)
    else:
        spec[-1] = _fit(shape[-1], in_ax, sizes)
    return tuple(spec)


def validate_quant_partition(params, mesh, mode: str = "serve") -> None:
    """Raise where a sharding of a quantized leaf's trailing (storage)
    qvalues axis would leave a shard with part of a group: each shard must
    hold whole groups of group_size // pack * pack_storage storage elements
    (int4: GS/2 bytes, int3: 3*GS/8). The PTQ policy gives this by
    construction; the check catches drift between policy and placement (a
    new packed format, a hand-built mesh)."""
    sizes = axis_sizes(mesh)
    for p, leaf in tensor_items(params, quant=True):
        if not isinstance(leaf, QuantizedTensor):
            continue
        spec = param_spec(f"{p}/qvalues", leaf.qvalues.shape, mesh=mesh, mode=mode)
        last = spec[-1] if len(spec) else None
        if last is None:
            continue
        axes = last if isinstance(last, tuple) else (last,)
        ways = int(math.prod(sizes.get(a, 1) for a in axes))
        fmt = get_format(leaf.fmt)
        per_group = leaf.group_size // fmt.pack * fmt.pack_storage
        dim = leaf.qvalues.shape[-1]
        if ways > 1 and (dim // ways) % per_group:
            raise ValueError(
                f"{p}: {ways}-way sharding of the packed qvalues axis "
                f"({dim} storage elements) splits quantization groups of "
                f"{per_group} storage elements ({leaf.fmt}, GS={leaf.group_size})"
            )


def param_specs(params, mesh, mode: str = "train") -> dict[str, Spec]:
    """{path: spec} over a parameter tree's tensors (a QuantizedTensor's
    ``qvalues`` and ``scales`` under its path), in ``tensor_items`` order."""
    return {path: param_spec(path, leaf.shape, mesh=mesh, mode=mode)
            for path, leaf in tensor_items(params)}


# ---------------------------------------------------------------------------
# caches / batches / outputs
# ---------------------------------------------------------------------------

def cache_spec(name: str, shape, *, mesh, batch: int) -> Spec:
    """KV/state-cache placement: batch -> data, the axis after it (sequence
    for KV caches, heads for RWKV/SSM states) -> model; at batch 1 the
    sequence spreads over the whole mesh when it divides. ``name`` is the
    leaf name or its '/'-joined path. ``*_pages`` leaves (the paged pool
    (L, NB, BS, KV, hd)) shard kv heads over model and never the block axis;
    ``*_scales`` (L, NB, BS, KV) follow their pages. Leaves under a
    ``mamba`` subtree (zamba's (groups, per_group, batch, ...) states) pin
    the batch to axis 2. Every other leaf leads with a stack axis, so the
    batch search starts at index 1: a layer count equal to the batch is
    not taken for it."""
    sizes = axis_sizes(mesh)
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    if name.endswith("_pages") or name.endswith("_scales"):
        if ndim >= 2:
            idx = -2 if name.endswith("_pages") else -1
            spec[idx] = _fit(shape[idx], MODEL_AXIS, sizes)
        return tuple(spec)
    parents = name.split("/")[:-1]
    if "mamba" in parents and ndim >= 4:
        b_idx = 2
    elif ndim >= 3:
        search = range(1, max(2, ndim - 2))
        b_idx = next((i for i in search if shape[i] == batch), 1)
    else:
        b_idx = 0 if ndim and shape[0] == batch else min(1, ndim - 1)
    if batch > 1:
        spec[b_idx] = _fit(batch, DATA_AXIS, sizes)
    seq_idx = b_idx + 1
    if seq_idx < ndim:
        d = shape[seq_idx]
        full = int(math.prod(sizes.values()))
        if batch == 1 and full > 1 and d % full == 0 and len(sizes) > 1:
            spec[seq_idx] = tuple(axis_names(mesh))
        else:
            spec[seq_idx] = _fit(d, MODEL_AXIS, sizes)
    return tuple(spec)


def cache_specs(cache, mesh, batch: int) -> dict[str, Spec]:
    """{path: spec} over a cache tree, keyed by each leaf's full path, so
    path-dependent layouts (zamba's ``mamba/*``) find their batch axis."""
    return {path: cache_spec(path, leaf.shape, mesh=mesh, batch=batch)
            for path, leaf in tensor_items(cache)}


def _batch_spec(shape, dp: tuple[str, ...], dp_sz: int) -> Spec:
    if len(shape) and dp and dp_sz > 1 and shape[0] % dp_sz == 0:
        return (_entry(dp), *([None] * (len(shape) - 1)))
    return (None,) * len(shape)


def batch_specs(batch, mesh) -> dict[str, Spec]:
    """{key: spec} of data-parallel input batches: the leading axis over
    every non-model axis where it divides, else replicated (odd eval
    batches never fail)."""
    dp, dp_sz = dp_axes(mesh), _dp_size(mesh)
    return {path: _batch_spec(tuple(leaf.shape), dp, dp_sz)
            for path, leaf in tensor_items(batch)}


def logits_spec(mesh, ndim: int, batch: int) -> Spec:
    """Output logits: batch -> dp axes (where divisible), vocab -> model."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dp_sz = _dp_size(mesh)
    first = _entry(dp) if (dp and dp_sz > 1 and batch % dp_sz == 0) else None
    last = MODEL_AXIS if sizes.get(MODEL_AXIS, 1) > 1 else None
    return (first, *([None] * (ndim - 2)), last)


def verify_logits_spec(mesh, batch: int) -> Spec:
    """Speculative-verify logits (b, k, vocab): batch -> dp, vocab -> model,
    the k verify positions of a request on one data shard."""
    return logits_spec(mesh, 3, batch)


# ---------------------------------------------------------------------------
# shards: shapes, DTensor placements, placing and gathering
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of one device's block of a ``shape`` tensor under ``spec``
    (every split divides: the rules drop an axis that does not)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        ways = math.prod(sizes[a] for a in _entry_axes(entry))
        if dim % ways:
            raise ValueError(f"{ways}-way split of a {dim}-wide dim in {spec}")
        out.append(dim // ways)
    return (*out, *shape[len(spec):])


def shard_nbytes(shape, dtype: torch.dtype, spec: Spec, mesh) -> int:
    """Bytes of one device's block of a ``shape`` ``dtype`` tensor."""
    return math.prod(shard_shape(tuple(shape), spec, mesh)) * dtype.itemsize


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one entry a mesh
    dimension, ``Shard(d)`` where tensor dim d is split over that mesh
    axis, else ``Replicate()``. A dim split over several axes lists them in
    mesh order (outermost first), as both JAX and DTensor lay them out."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{entry}: a dim split over several axes must name them in "
                             f"mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def block(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``, row-major over the axes
    of a split dim (the first outermost): a copy where it is smaller than
    ``full`` (the rank keeps its block only), else ``full`` itself."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    out = full
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        ways, idx = 1, 0
        for a in axes:
            ways, idx = ways * sizes[a], idx * sizes[a] + coord[a]
        n = full.shape[d] // ways
        out = out.narrow(d, idx * n, n)
    return out.clone() if out.numel() < full.numel() else out


def place(full: torch.Tensor, spec: Spec, mesh):
    """``full`` (the same on every rank) as a DTensor on ``mesh`` under
    ``spec``; each rank keeps its own block (no communication)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(block(full, spec, mesh), mesh, placements(spec, mesh),
                              run_check=False)


def _spec_of(like) -> Spec:
    """The spec a DTensor's placements stand for."""
    from torch.distributed.tensor import Shard

    names = axis_names(like.device_mesh)
    spec: list[Any] = [None] * like.ndim
    for i, p in enumerate(like.placements):
        if isinstance(p, Shard):
            spec[p.dim] = _entry_axes(spec[p.dim]) + (names[i],)
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def block_like(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's block of ``full`` as DTensor ``like`` is cut; ``full``
    itself where ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return full
    return block(full, _spec_of(like), like.device_mesh)


def local_like(t: torch.Tensor, like):
    """A rank's block ``t`` as a DTensor placed as ``like`` is (``t`` itself
    where ``like`` is a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements, run_check=False)


def place_like(full: torch.Tensor, like):
    """``full`` placed as DTensor ``like`` is (its mesh and placements);
    ``full`` itself where ``like`` is a plain tensor."""
    return local_like(block_like(full, like), like)


def distribute(tree, specs: dict[str, Spec], mesh):
    """``tree`` (nested dicts, NamedTuples, QuantizedTensors) with every
    tensor placed on ``mesh`` by ``specs`` ({path: spec}, from
    ``param_specs`` and its kin); a path ``specs`` lacks is an error."""
    return tensor_map_with_path(lambda path, t: place(t, specs[path], mesh), tree)


def gather_leaf(t):
    """A DTensor's full tensor (a collective on its mesh); else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """A DTensor's local block; else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def gather(tree):
    """The inverse of :func:`distribute`: every DTensor gathered to its full
    tensor, in ``tensor_items`` order on every rank (each gather is a
    collective)."""
    return tensor_map_with_path(lambda _, t: gather_leaf(t), tree)
