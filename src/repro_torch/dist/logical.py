"""Logical sharding axes (counterpart of ``repro/dist/logical.py``).

Logical names — "dp" (data/batch), "tp" (tensor/model), "seq" (one
dimension over the whole mesh, the batch-1 long-context case) — are bound
to whatever mesh is active:

    with logical.use_mesh_rules(mesh):
        logical.spec(shape, "dp", "tp")

Outside ``use_mesh_rules`` ``size()`` is 1 and ``spec`` is all None. Inside,
``spec`` drops an axis that is unknown, of size 1, does not divide its
dimension or was already used by an earlier dimension, as the reference's
does (the same degrade-don't-fail contract as ``sharding.param_spec``).

A mesh is a ``DeviceMesh`` or a shape-only :class:`MeshShape`. The port
computes on gathered tensors (``sharding.gather``; the model axis shards
storage, not compute), so its models carry no ``constrain`` calls:
``constrain`` returns its tensor unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axes alone: ``shape`` maps each axis name to its size,
    ``axis_names`` orders them (row-major, as JAX's and DeviceMesh's
    devices are laid out)."""

    shape: Mapping[str, int]
    axis_names: tuple[str, ...]

    @classmethod
    def of(cls, sizes: tuple[int, ...], names: tuple[str, ...]) -> "MeshShape":
        return cls(dict(zip(names, sizes)), tuple(names))


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names in order (a DeviceMesh's ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or a shape-only mesh."""
    names = axis_names(mesh)
    if isinstance(mesh.shape, Mapping):
        return {a: int(mesh.shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in mesh.shape)))


_ACTIVE: "_Rules | None" = None


class _Rules:
    """Logical-name -> mesh-axes binding for one mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        names = axis_names(mesh)
        dp = tuple(a for a in names if a != MODEL_AXIS)
        tp = (MODEL_AXIS,) if MODEL_AXIS in names else ()
        self.axes = {"dp": dp, "tp": tp, "seq": dp + tp}

    def size(self, name: str) -> int:
        return int(math.prod(self.sizes[a] for a in self.axes.get(name, ())))


@contextlib.contextmanager
def use_mesh_rules(mesh):
    """Bind logical names to ``mesh`` for the enclosed scope (re-entrant)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _Rules(mesh)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh bound by the innermost ``use_mesh_rules``, or None."""
    return _ACTIVE.mesh if _ACTIVE is not None else None


def size(name: str) -> int:
    """Total device count behind logical axis ``name`` (1 when off-mesh)."""
    return _ACTIVE.size(name) if _ACTIVE is not None else 1


def spec(shape, *axes) -> tuple[Any, ...]:
    """Resolve logical ``axes`` against the active rules for ``shape``: one
    entry a dimension, None, an axis name or a tuple of names (a
    ``PartitionSpec``'s entries). An axis is dropped when no rules are
    active, the name is unknown, its size is 1, it does not divide the
    dimension, or its mesh axes were used by an earlier dimension."""
    if _ACTIVE is None:
        return (None,) * len(shape)
    used: set[str] = set()
    out: list[Any] = []
    for dim, ax in zip(shape, axes):
        phys = _ACTIVE.axes.get(ax, ()) if ax else ()
        sz = math.prod(_ACTIVE.sizes[a] for a in phys) if phys else 1
        if not phys or sz <= 1 or dim % sz or any(a in used for a in phys):
            out.append(None)
            continue
        used.update(phys)
        out.append(phys[0] if len(phys) == 1 else phys)
    out += [None] * (len(shape) - len(out))
    return tuple(out)


def constrain(x, *axes):
    """The reference's sharding constraint keyed on logical names. The port
    computes on gathered tensors, so ``x`` comes back unchanged; with rules
    active, more axes than ``x`` has dimensions raise as the reference's."""
    if _ACTIVE is not None and len(axes) > x.ndim:
        raise ValueError(f"{len(axes)} axes for rank-{x.ndim} value")
    return x
