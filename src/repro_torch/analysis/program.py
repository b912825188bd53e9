"""One step of a program, recorded: the port's counterpart of the
reference's ``analysis/hlo.py`` and ``launch/hlo_analysis.py``.

The reference reads what XLA compiled: bytes and dot FLOPs per instruction,
aliases, loop trip counts, collectives, and a :class:`Roofline` from them.
The port's programs are eager torch on the CPU and captured CUDA graphs on
the card, so a step is read in one of two ways.

- **On the CPU** (:func:`record_step`): a ``TorchDispatchMode`` records
  every aten op of the step as a :class:`Node` (its tensors' shape, dtype
  and storage identity, and which arguments it writes in place, read from
  the op's schema: ``alias_info.is_write``), and the ``kernels/ops.py``
  entry points (``quantized_matmul``, ``paged_attention``,
  ``flash_attention``, ``rmsnorm_quant``) each record one node with their
  kernel hook, weight leaf and cache tensors. Recording of the ops inside
  an entry point is suspended: on the card they are the kernel's
  registers. The step may run on meta tensors (``models/registry.
  param_struct``): a decode step reads nothing on the host.
- **On the card** (:func:`card_record`): the kernel nodes of a captured
  program (``serving/graphs.kernel_nodes``: the function, its name, grid,
  block, dynamic shared memory and argument values), each pointer argument
  mapped to the tensor whose storage holds it (the program's weights, its
  cache, its other buffers) or to the graph pool's block.

:func:`roofline_from_record` gives the reference's :class:`Roofline`
fields from a record's operations and bytes and ``kernels/bounds.py``'s
peaks; nothing is timed, so ``mfu`` stays 0.
"""

from __future__ import annotations

import bisect
import dataclasses
import inspect
import re
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.quant import get_format
from repro_torch.core.tree import tensor_items
from repro_torch.kernels import ops
from repro_torch.kernels.bounds import HBM_BYTES_PER_S, PEAK_OPS_PER_S

__all__ = ["CardRecord", "Node", "Roofline", "StepRecord", "TensorRef", "card_record",
           "kernel_signature", "record_step", "roofline_from_record"]

# NVLink between H100 SXM cards (data sheet, both directions): the collective
# term's rate; one card has no collective
LINK_BYTES_PER_S = 900e9

COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

_RATE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "bf16"}


def storage_id(t: torch.Tensor) -> int:
    """The identity of a tensor's storage, shared by its views (meta tensors
    too, whose data pointers are all 0)."""
    return t.untyped_storage()._cdata


@dataclasses.dataclass(frozen=True)
class TensorRef:
    shape: tuple[int, ...]
    dtype: torch.dtype
    storage: int
    nbytes: int


def tensor_ref(t: torch.Tensor) -> TensorRef:
    return TensorRef(tuple(t.shape), t.dtype, storage_id(t), t.numel() * t.element_size())


@dataclasses.dataclass(frozen=True)
class Node:
    """One recorded op (``kind`` "op": an aten overload such as
    ``aten.mm.default``) or entry point (``kind`` "entry": ``name`` is the
    entry point, ``hook`` its kernel). ``outputs`` are the new buffers an op
    returns (views and in-place results are not), ``writes`` the arguments
    it writes in place, ``weight`` the parameter path of an entry point's
    weight leaf (``weight_bytes`` its slice's storage bytes), ``cache`` the
    cache tensors an entry point reads, ``ops`` its operations at ``rate``."""

    kind: str
    name: str
    inputs: tuple[TensorRef, ...]
    outputs: tuple[TensorRef, ...]
    writes: tuple[TensorRef, ...] = ()
    hook: str | None = None
    weight: str | None = None
    weight_bytes: int = 0
    cache: tuple[TensorRef, ...] = ()
    ops: int = 0
    rate: str = "f32"

    @property
    def namespace(self) -> str:
        return self.name.split(".", 1)[0]


@dataclasses.dataclass
class StepRecord:
    """The nodes of one recorded step, in call order; ``cache_storages``
    maps each cache leaf's storage to its path, ``weight_storages`` each
    weight leaf's."""

    nodes: list[Node]
    cache_storages: dict[int, str]
    weight_storages: dict[int, str]

    def entries(self, name: str | None = None) -> list[Node]:
        return [n for n in self.nodes if n.kind == "entry" and name in (None, n.name)]

    def glue(self) -> list[Node]:
        return [n for n in self.nodes if n.kind == "op"]

    def collectives(self) -> list[Node]:
        return [n for n in self.glue() if n.namespace in COLLECTIVE_NAMESPACES]

    def projections(self) -> list[Node]:
        return self.entries("quantized_matmul")

    def written_storages(self) -> set[int]:
        return {r.storage for n in self.nodes for r in n.writes}

    def hbm_bytes(self) -> int:
        """Bytes the step moves: each entry point's weight slice and cache
        tensors, and each op's new buffers and the cache it reads."""
        total = 0
        for n in self.nodes:
            if n.kind == "entry":
                total += n.weight_bytes + sum(r.nbytes for r in n.cache)
            else:
                total += sum(r.nbytes for r in n.outputs)
                total += sum(r.nbytes for r in n.inputs if r.storage in self.cache_storages)
        return total

    def ops_by_rate(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for n in self.nodes:
            if n.ops:
                out[n.rate] = out.get(n.rate, 0) + n.ops
        return out


def _refs(tree) -> list[TensorRef]:
    return [tensor_ref(t) for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


# dot products among the ops: (m, k) x (k, n), and batched
_DOTS = {"aten.mm.default", "aten.addmm.default", "aten.bmm.default", "aten.baddbmm.default"}


def _dot_ops(name: str, args) -> int:
    """2 m n k of a dot op (b m n k batched), from its operands' shapes."""
    if name not in _DOTS:
        return 0
    a, b = (args[1], args[2]) if name in ("aten.addmm.default", "aten.baddbmm.default") \
        else (args[0], args[1])
    return 2 * a.numel() * b.shape[-1]


class _Recorder(TorchDispatchMode):
    """Records aten ops outside the entry points, and each entry point
    (``ops.RECORDERS``) as one node."""

    def __init__(self, weight_storages: dict[int, str], cache_storages: dict[int, str]):
        super().__init__()
        self.nodes: list[Node] = []
        self.depth = 0
        self.weight_storages, self.cache_storages = weight_storages, cache_storages

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        schema = func._schema
        named = dict(zip((a.name for a in schema.arguments), args))
        named.update(kwargs)
        writes = [v for a in schema.arguments if a.alias_info is not None
                  and a.alias_info.is_write for v in tree_flatten(named.get(a.name))[0]
                  if isinstance(v, torch.Tensor)]
        outs = out if isinstance(out, (tuple, list)) else (out,)
        new = [o for r, o in zip(schema.returns, outs) if r.alias_info is None]
        if len(outs) > len(schema.returns):     # a Tensor[] return
            new = list(outs) if schema.returns and schema.returns[0].alias_info is None else []
        name = str(func)
        rate = next((_RATE[t.dtype] for t in tree_flatten(args)[0]
                     if isinstance(t, torch.Tensor) and t.dtype in _RATE), "f32")
        self.nodes.append(Node("op", name, tuple(_refs((args, kwargs))), tuple(_refs(new)),
                               tuple(tensor_ref(t) for t in writes),
                               ops=_dot_ops(name, args), rate=rate))
        return out

    def entry(self, fn: Callable, args, kwargs):
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        name = fn.__name__
        self.depth += 1
        try:
            if name == "quantized_matmul" and a["x"].is_meta:
                # meta tensors have no values: the product is its shape only
                out = torch.empty((*a["x"].shape[:-1], a["w"].shape[0]), dtype=torch.float32,
                                  device="meta")
            else:
                out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        tensors = [v for v in tree_flatten(list(a.values()))[0] if isinstance(v, torch.Tensor)]
        kw: dict = {}
        if name == "quantized_matmul":
            w, x = a["w"], a["x"]
            rows = x.numel() // x.shape[-1]
            kw = dict(hook=get_format(w.fmt).kernel,
                      weight=self.weight_storages.get(storage_id(w.qvalues)),
                      weight_bytes=sum(t.numel() * t.element_size()
                                       for t in (w.qvalues, w.scales)),
                      ops=2 * rows * w.shape[0] * w.shape[1],
                      rate="bf16" if w.fmt == "fp8" else "int8")
            tensors = [x] + ([a["xq"].qvalues, a["xq"].scales] if a["xq"] is not None else [])
        elif name == "paged_attention":
            q, kp = a["q"], a["k_pages"]
            cache = [t for t in (kp, a["v_pages"], a["k_scales"], a["v_scales"]) if t is not None]
            cols = a["block_table"].shape[1] * kp.shape[1]
            kw = dict(hook="paged_attn_quant" if a["k_scales"] is not None else "paged_attn",
                      cache=tuple(tensor_ref(t) for t in cache),
                      ops=4 * q.numel() * cols, rate=_RATE.get(q.dtype, "f32"))
        elif name == "flash_attention":
            q, k = a["q"], a["k"]
            s, t = q.shape[1], k.shape[1]
            pairs = s * (s + 1) // 2 if a["causal"] and s == t else s * t
            kw = dict(hook="flash_attn", ops=4 * q.shape[0] * q.shape[2] * pairs,
                      rate=_RATE.get(q.dtype, "f32"))
        elif name == "rmsnorm_quant":
            kw = dict(hook="rmsnorm_quant", ops=8 * a["x"].numel())
        self.nodes.append(Node("entry", name, tuple(tensor_ref(t) for t in tensors),
                               tuple(_refs(out)), **kw))
        return out


def storages(tree) -> dict[int, str]:
    """{storage identity: path} of every tensor of a tree (a
    QuantizedTensor's qvalues and scales under the leaf's path)."""
    out: dict[int, str] = {}
    for path, t in tensor_items(tree):
        leaf = path.rsplit("/", 1)[0] if path.endswith(("/qvalues", "/scales")) else path
        out.setdefault(storage_id(t), leaf)
    return out


def record_step(fn: Callable, args: tuple = (), kwargs: dict | None = None, *, weights=None,
                cache=None) -> tuple[StepRecord, object]:
    """Run ``fn(*args, **kwargs)`` once under the recorder -> (its record,
    its result). ``weights`` and ``cache`` are the trees whose storages
    name the entry points' weight leaves and the cache leaves."""
    rec = _Recorder(storages(weights or {}), storages(cache or {}))
    ops.RECORDERS.append(rec)
    try:
        with rec:
            out = fn(*args, **(kwargs or {}))
    finally:
        ops.RECORDERS.remove(rec)
    return StepRecord(rec.nodes, rec.cache_storages, rec.weight_storages), out


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """The reference's roofline fields for one step on ``chips`` cards:
    operations by their rate type (``kernels/bounds.PEAK_OPS_PER_S``), HBM
    bytes, collective bytes. Nothing is timed, so ``mfu`` is 0."""

    ops: dict[str, float]
    hbm_bytes: float
    collective_bytes: float = 0.0
    chips: int = 1
    model_flops: float = 0.0

    @property
    def flops(self) -> float:
        return float(sum(self.ops.values()))

    @property
    def compute_s(self) -> float:
        return sum(n / PEAK_OPS_PER_S[r] for r, n in self.ops.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        return 0.0

    def as_dict(self) -> dict:
        return {"ops_by_rate": dict(self.ops), "flops_per_device": self.flops,
                "hbm_bytes_per_device": self.hbm_bytes,
                "collective_bytes_per_device": self.collective_bytes, "chips": self.chips,
                "compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "step_s": self.step_s, "model_flops": self.model_flops, "mfu": self.mfu}


def roofline_from_record(rec: StepRecord, chips: int = 1, model_flops: float = 0.0) -> Roofline:
    """A :class:`Roofline` of one recorded step: the entry points' and dot
    ops' operations, :meth:`StepRecord.hbm_bytes`, and the collectives'
    operand bytes."""
    coll = sum(r.nbytes for n in rec.collectives() for r in n.inputs)
    return Roofline(dict(rec.ops_by_rate()), float(rec.hbm_bytes()), float(coll), chips,
                    model_flops)


# ---------------------------------------------------------------------------
# the card: a captured program's kernel nodes
# ---------------------------------------------------------------------------

_BUILTIN = {"v": "void", "b": "bool", "c": "char", "a": "signed char", "h": "unsigned char",
            "s": "short", "t": "unsigned short", "i": "int", "j": "unsigned int",
            "l": "long", "m": "unsigned long", "x": "long long", "y": "unsigned long long",
            "f": "float", "d": "double"}


def _source_name(s: str, i: int) -> tuple[str, int]:
    m = re.match(r"\d+", s[i:])
    n = int(m.group())
    i += len(m.group())
    return s[i:i + n], i + n


def _type(s: str, i: int) -> tuple[str, int]:
    """One mangled type (or template argument) at ``s[i]`` -> (its last
    name, the index past it)."""
    c = s[i]
    if c in "KPRV":                     # const / pointer / reference / volatile
        return _type(s, i + 1)
    if c == "L":                        # a literal: L <type> <value> E
        j = s.index("E", i)
        lit = s[i + 2:j]
        return str(-int(lit[1:]) if lit.startswith("n") else int(lit)), j + 1
    if c == "N":                        # a nested name: N <names> E
        i, last = i + 1, ""
        while s[i] != "E":
            if s[i] == "I":
                _, i = _template_args(s, i)
            elif s[i].isdigit():
                last, i = _source_name(s, i)
            else:
                last, i = _type(s, i)
        return last, i + 1
    if c == "S":                        # a substitution: S_ or S<seq>_
        return "?", s.index("_", i) + 1
    if c == "T":                        # a template parameter: T_ or T<n>_
        return "?", s.index("_", i) + 1
    if c.isdigit():
        name, i = _source_name(s, i)
        if i < len(s) and s[i] == "I":
            _, i = _template_args(s, i)
        return name, i
    return _BUILTIN.get(c, c), i + 1


def _template_args(s: str, i: int) -> tuple[list[str], int]:
    out, i = [], i + 1                  # past the I
    while s[i] != "E":
        arg, i = _type(s, i)
        out.append(arg)
    return out, i + 1


def kernel_signature(mangled: str) -> tuple[str, list[str]]:
    """(base name, template arguments) of a mangled kernel name: a
    literal's value (``Li8E`` -> "8", ``Lb1E`` -> "1"), a type's last name
    (``13__nv_bfloat16``; the anonymous namespace's ``StreamInt8``). A name
    that is not Itanium-mangled comes back whole, with no arguments."""
    if not mangled.startswith("_Z"):
        return mangled, []
    try:
        s, i = mangled, 2
        if s[i] == "N":                 # a nested name: the kernel is its last part
            i += 1
            name, args = "", []
            while s[i] != "E":
                if s[i] == "I":
                    args, i = _template_args(s, i)
                elif s[i].isdigit():
                    name, i = _source_name(s, i)
                    args = []
                else:
                    _, i = _type(s, i)
            return name, args
        name, i = _source_name(s, i)
        args = []
        if i < len(s) and s[i] == "I":
            args, _ = _template_args(s, i)
        return name, args
    except (ValueError, IndexError, AttributeError):
        return mangled, []


@dataclasses.dataclass(frozen=True)
class Span:
    """A range of device addresses and what it holds: ``kind`` "weight",
    "cache", "buffer" (another static buffer of the program) or "pool" (a
    block of the program's graph pool, ``nbytes`` its size)."""

    start: int
    nbytes: int
    kind: str
    name: str
    slice_bytes: int = 0        # a stacked leaf's one layer; else nbytes


@dataclasses.dataclass
class CardRecord:
    """The kernel nodes of one captured program and, for each, the spans
    its pointers fall in ((argument, byte offset in it) -> span, offset)."""

    nodes: list
    hits: list[dict[tuple[int, int], tuple[Span, int]]]

    def reads(self, kind: str) -> list[tuple[int, Span, int, bool]]:
        """(node index, span, offset, whether the pointer is an argument of
        its own and not a word inside a struct argument) of every pointer
        into a span of ``kind``."""
        return [(i, span, off, len(self.nodes[i].args[j]) == 8)
                for i, h in enumerate(self.hits) for (j, _), (span, off) in h.items()
                if span.kind == kind]


def _spans_of(tree, kind: str, layers: int = 0) -> list[Span]:
    """A span per tensor of ``tree``; a leaf under ``layers/`` stacked by
    layer (leading dim ``layers``) in slices of one layer."""
    out = []
    for path, t in tensor_items(tree):
        if not isinstance(t, torch.Tensor) or not t.is_cuda or t.numel() == 0:
            continue
        nbytes = t.numel() * t.element_size()
        stacked = path.startswith("layers/") and t.ndim and t.shape[0] == layers
        out.append(Span(t.data_ptr(), nbytes, kind, path,
                        nbytes // layers if stacked else nbytes))
    return out


def pool_spans(prog) -> list[Span]:
    """The blocks of a captured program's graph pool (its segments in
    ``torch.cuda.memory_snapshot()``), each with its size."""
    out = []
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", ())) != tuple(prog.pool or ()):
            continue
        addr = seg["address"]
        for blk in seg["blocks"]:
            out.append(Span(addr, blk["size"], "pool", blk.get("state", "")))
            addr += blk["size"]
    return out


def card_record(prog, weights, layers: int = 0) -> CardRecord:
    """The kernel nodes of captured ``prog`` with each pointer argument
    mapped to a weight tensor of ``weights`` (``layers``: the depth its
    stacked leaves hold), a leaf of the program's cache
    (``prog.inputs["cache"]``), another of its static inputs, or a block of
    its graph pool."""
    from repro_torch.serving.graphs import kernel_nodes

    spans = _spans_of(weights, "weight", layers) + _spans_of(prog.inputs.get("cache", {}), "cache")
    spans += _spans_of({k: v for k, v in prog.inputs.items() if k != "cache"}, "buffer")
    spans += pool_spans(prog)
    spans.sort(key=lambda s: s.start)
    starts = [s.start for s in spans]
    nodes = kernel_nodes(prog)
    hits = []
    for node in nodes:
        h = {}
        for j, raw in enumerate(node.args):
            # every aligned 8-byte word: a pointer argument, or one inside a
            # struct argument (PyTorch's elementwise kernels pass theirs so)
            for w in range(0, len(raw) - 7, 8):
                v = int.from_bytes(raw[w:w + 8], "little")
                k = bisect.bisect_right(starts, v) - 1
                if v and k >= 0 and v < spans[k].start + spans[k].nbytes:
                    h[(j, w)] = (spans[k], v - spans[k].start)
        hits.append(h)
    return CardRecord(nodes, hits)
