"""repro-xray for the port: contracts on the programs that really run
(counterpart of ``repro/analysis/xray.py``).

The reference compiles its serving programs with XLA and audits the HLO.
The port's programs are eager torch on the CPU and captured CUDA graphs on
the card, so each contract has two halves: a CPU half over a recorded step
(``analysis/program.record_step``: every aten op outside the
``kernels/ops.py`` entry points, and each entry point as one node) and a
card half over a captured program's kernel nodes
(``analysis/program.card_record``), which ``chip_smoke.py`` runs on the
programs the card replays.

  xray-donation    every cache or pool leaf is written in place (an
                   in-place or ``out=`` op on its storage), and no decode or
                   verify op outputs a new tensor of a cache leaf's full
                   shape. Card: the cache keeps its addresses across a
                   replay, and the program's graph pool holds less than one
                   cache leaf.
  xray-dequant     outside the entry points no op outputs a float tensor of
                   a quantized weight's logical shape at or above
                   ``DEQUANT_THRESHOLD`` bytes. Card: no pointer argument
                   points at a graph-pool block of that size (a struct
                   argument's words may hold stale host bytes, so only
                   arguments that are pointers count here).
  xray-bytes       the bytes a decode step moves agree with the registry
                   ``nbytes`` model (``expected_decode_bytes``) within
                   ``BYTES_RTOL`` for every quant preset. Card: the storage
                   bytes of the weight leaves that kernel nodes read, every
                   quantized leaf read once, at storage width.
  xray-collective  no collective in a one-rank decode, and the projection
                   entry points (card: GQMV/GQMM nodes) number what
                   ``kernels/bounds.decode_projections`` counts (4 L + 1
                   for TinyLlama): the counterpart of the layer scan's trip
                   count.

The catalog: full-size TinyLlama decode at batch 1, cache 64 for each
quant preset and for int8 weights over an int8 and an fp8 KV cache,
recorded on meta tensors from ``models/registry.param_struct`` (a decode
step reads nothing on the host, so every row runs at full depth); and the
adapters' programs on reduced archs (tinyllama contiguous and paged with
spec k = 2, deepseek-v2-lite contiguous (MLA), rwkv6 recurrent), each
recorded once after a short serve on the CPU. The port's prefill programs
insert their rows into the cache (``model.insert_slots``, the pool's
``put``) in the same program, so the reference's insert programs are their
in-place writes. The catalog is built once per process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, Iterable

import torch

from repro_torch.analysis.engine import BaseChecker, Finding
from repro_torch.analysis.program import StepRecord, record_step

XRAY_ANCHOR = "src/repro_torch/analysis/xray.py"

# float weight-shaped buffers smaller than this are tolerated (reduced-arch
# test weights, per-row dequants of gathered embedding rows)
DEQUANT_THRESHOLD = 1 << 16

# recorded-vs-model relative tolerance, the reference's: a preset streaming
# its weights at the wrong width misses by 2x or more
BYTES_RTOL = 0.15

BYTES_PRESETS = ("int8", "int4", "mixed", "int3", "fp8", "mixed3")

# quantized-KV decode programs: int8 weights (the paper's), the cache at
# kv_quant width with its per-row f32 scale leaves
KV_QUANT_PRESETS = ("int8", "fp8")
BYTES_ARCH = "tinyllama-1.1b"
BYTES_BATCH = 1
BYTES_CACHE_LEN = 64

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@dataclasses.dataclass
class XrayProgram:
    """One recorded program step and its contract expectations."""

    name: str                      # e.g. "tinyllama-1.1b/contiguous/contiguous.decode"
    kind: str                      # decode | prefill | verify
    record: StepRecord
    path: str                      # repo-relative source anchor of the step function
    line: int
    cache_shapes: dict[str, tuple] = dataclasses.field(default_factory=dict)  # (shape, dtype)
    weight_sigs: frozenset = frozenset()   # quantized-weight logical shapes
    num_layers: int | None = None
    expected_projections: int | None = None
    expected_collectives: frozenset = frozenset()
    expected_bytes: float | None = None    # nbytes-model bytes per decode step
    fmt: str | None = None         # quant preset (bytes rows)


def _anchor(fn) -> tuple[str, int]:
    """Repo-relative (path, line) of a function."""
    code = getattr(getattr(fn, "__wrapped__", fn), "__code__", None)
    if code is None:
        return XRAY_ANCHOR, 1
    path = code.co_filename
    marker = os.sep + "src" + os.sep + "repro_torch" + os.sep
    if marker in path:
        path = "src/repro_torch/" + path.split(marker, 1)[1].replace(os.sep, "/")
    return path, code.co_firstlineno


def _cache_shapes(cache) -> dict[str, tuple]:
    from repro_torch.core.tree import tensor_items

    return {p: (tuple(t.shape), t.dtype) for p, t in tensor_items(cache)}


def weight_dims_sigs(qparams) -> frozenset:
    """Shapes a dequantized weight buffer could take: each QuantizedTensor's
    logical shape, its per-layer slice, and the transposed variants."""
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.core.tree import tree_leaves

    sigs: set[tuple] = set()
    for leaf in tree_leaves(qparams):
        if not isinstance(leaf, QuantizedTensor):
            continue
        shp = tuple(leaf.logical_shape)
        variants = [shp, shp[:-2] + (shp[-1], shp[-2])]
        if len(shp) >= 3:
            variants += [shp[1:], (shp[2], shp[1]), (1,) + shp[1:], (1, shp[2], shp[1])]
        sigs.update(variants)
    return frozenset(sigs)


def expected_decode_bytes(qparams, cache, batch: int, vocab: int,
                          cache_len: int) -> tuple[float, dict[str, float]]:
    """Registry-model bytes of one decode step -> (total, its terms):

      quantized     every quantized leaf at its ``nbytes()`` storage size
                    (the GQMV reads qvalues and scales once; the port keeps
                    its group sums in registers)
      embed         the embedding table at ``batch`` gathered rows
      float         the float leaves in full
      cache_read    the cache once: attention's read
      cache_commit  one row of every cache leaf committed a layer
      logits        the f32 logits the classifier's GQMV writes
    """
    from repro_torch.core.policy import leaf_class
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.core.tree import tensor_items, tree_items

    terms = dict.fromkeys(("quantized", "embed", "float", "cache_read", "cache_commit",
                           "logits"), 0.0)
    for path, leaf in tree_items(qparams):
        if isinstance(leaf, QuantizedTensor):
            if leaf_class(path) == "embed":
                terms["embed"] += leaf.nbytes() * batch / leaf.logical_shape[0]
            else:
                terms["quantized"] += leaf.nbytes()
        else:
            terms["float"] += leaf.numel() * leaf.element_size()
    for _, leaf in tensor_items(cache):
        nb = leaf.numel() * leaf.element_size()
        terms["cache_read"] += nb
        terms["cache_commit"] += nb / cache_len
    terms["logits"] = batch * vocab * 4
    return sum(terms.values()), terms


# ---------------------------------------------------------------------------
# program catalog
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


@torch.inference_mode()
def decode_program(model, qparams, *, fmt: str, batch: int = BYTES_BATCH,
                   cache_len: int = BYTES_CACHE_LEN, device: str = "meta",
                   expect_layers: int | None = None,
                   step: Callable | None = None) -> XrayProgram:
    """A decode row: ``model.decode`` (or ``step(params, tok, cache, pos)``)
    recorded once on ``device`` at ``batch`` x ``cache_len``, with the
    bytes, dequant and projection expectations of ``qparams`` at
    ``expect_layers`` layers (the model's own by default)."""
    from repro_torch.kernels import bounds

    cfg = model.cfg
    cache = model.init_cache(batch, cache_len, cfg.cdtype(), device)
    tok = torch.zeros((batch,), dtype=torch.long, device=device)
    pos = torch.zeros((batch,), dtype=torch.long, device=device)
    step = step or model.decode
    rec, _ = record_step(step, (qparams, tok, cache, pos), weights=qparams, cache=cache)
    layers = expect_layers if expect_layers is not None else cfg.num_layers
    want_cfg = dataclasses.replace(cfg, num_layers=layers)
    path, line = _anchor(model.decode)
    return XrayProgram(
        name=f"{cfg.arch_id}/decode[{fmt}]", kind="decode", record=rec,
        path=path, line=line, cache_shapes=_cache_shapes(cache),
        weight_sigs=weight_dims_sigs(qparams), num_layers=layers,
        expected_projections=sum(c for _, _, c in bounds.decode_projections(want_cfg)),
        expected_bytes=expected_decode_bytes(qparams, cache, batch, cfg.vocab_size,
                                             cache_len)[0], fmt=fmt)


def _build_bytes_programs() -> list[XrayProgram]:
    """Full-size single-request decode per quant preset and quantized-KV
    cache, on meta tensors: the traffic, dequant and projection rows."""
    from repro_torch.core.policy import quantize_params
    from repro_torch.models.registry import build, load_config, param_struct

    cfg = load_config(BYTES_ARCH)
    model = build(cfg)
    pstruct = param_struct(cfg)
    progs = [decode_program(model, quantize_params(pstruct, cfg.group_size, formats=fmt),
                            fmt=fmt) for fmt in BYTES_PRESETS]
    qstruct = quantize_params(pstruct, cfg.group_size, formats="int8")
    for kvq in KV_QUANT_PRESETS:
        kmodel = build(dataclasses.replace(cfg, kv_quant=kvq))
        progs.append(decode_program(kmodel, qstruct, fmt=f"int8+kv_{kvq}"))
    return progs


SERVING_ARCHS = (("tinyllama-1.1b", "contiguous", True),
                 ("tinyllama-1.1b", "paged", True),
                 ("deepseek-v2-lite-16b", "contiguous", False),
                 ("rwkv6-7b", "recurrent", False))
SLOTS, CHUNK, SPEC_K, CACHE_LEN, PLEN = 2, 3, 2, 64, 8


def _program_kind(name: str) -> str:
    return name.rsplit(".", 1)[-1]


@torch.inference_mode()
def serving_programs(engine, adapter_kind: str, spec: bool) -> list[XrayProgram]:
    """Every program a short serve through ``adapter_kind`` builds on
    ``engine`` (CPU), each recorded once on its own static buffers after
    the serve."""
    from repro_torch.serving.core import ContiguousAdapter, RecurrentAdapter, Request, \
        SchedulerCore
    from repro_torch.serving.paged import PagedAdapter

    cls = {"contiguous": ContiguousAdapter, "paged": PagedAdapter,
           "recurrent": RecurrentAdapter}[adapter_kind]
    vocab = engine.cfg.vocab_size
    # a group of SLOTS - 1 prompts, then one (the third waits for a slot)
    reqs = [Request(i, [(7 * i + j) % vocab for j in range(PLEN)], max_new=4)
            for i in range(SLOTS + 1)]
    for spec_k in (None, SPEC_K) if spec else (None,):
        SchedulerCore(engine, cls(engine), slots=SLOTS, chunk=CHUNK,
                      spec_k=spec_k).serve(reqs, 4)
    progs = []
    for prog in engine.graphs.programs.values():
        cache = prog.inputs.get("cache", {})
        rec, _ = record_step(prog.fn, kwargs=prog.inputs, weights=engine.params, cache=cache)
        path, line = _anchor(prog.fn)
        kind = _program_kind(prog.name)
        # a prefill program per (group size, prompt length)
        tag = "[{}x{}]".format(*prog.key[2][-2:]) if kind == "prefill" else ""
        progs.append(XrayProgram(
            name=f"{engine.cfg.arch_id}/{adapter_kind}/{prog.name}{tag}", kind=kind,
            record=rec, path=path, line=line, cache_shapes=_cache_shapes(cache)))
    return progs


def _build_serving_programs() -> list[XrayProgram]:
    """The reduced-arch adapter sweep: each adapter's decode, verify and
    prefill (with its insert) programs."""
    from repro_torch.models.registry import build, load_config
    from repro_torch.serving.engine import InferenceEngine

    progs = []
    for arch, kind, spec in SERVING_ARCHS:
        cfg = load_config(arch).reduced()
        model = build(cfg)
        engine = InferenceEngine(model, model.init(seed=0, device="cpu"), cache_len=CACHE_LEN,
                                 sanitize=False, device="cpu")
        progs += serving_programs(engine, kind, spec)
    return progs


@functools.lru_cache(maxsize=1)
def catalog() -> tuple[XrayProgram, ...]:
    """Every audited program, built once per process."""
    return tuple(_build_bytes_programs() + _build_serving_programs())


# ---------------------------------------------------------------------------
# audits (the CPU halves)
# ---------------------------------------------------------------------------

def audit_donation(prog: XrayProgram) -> Iterable[Finding]:
    """Every cache leaf is written in place; no decode or verify op
    outputs a new tensor of a cache leaf's full shape."""
    rec = prog.record
    if not rec.cache_storages:
        return
    written = rec.written_storages()
    for storage, path in sorted(rec.cache_storages.items(), key=lambda kv: kv[1]):
        if storage not in written:
            yield Finding(
                "xray-donation", prog.path, prog.line,
                f"{prog.name}: cache leaf `{path}` is never written in place (no in-place or "
                "out= op on its storage) — the program copies or rebuilds its cache instead of "
                "committing into the static buffer it was given")
    if prog.kind not in ("decode", "verify"):
        return
    full = {sig: path for path, sig in prog.cache_shapes.items()}
    for node in rec.glue():
        for r in node.outputs:
            if (r.shape, r.dtype) in full:
                yield Finding(
                    "xray-donation", prog.path, prog.line,
                    f"{prog.name}: {node.name} outputs a new {list(r.shape)} tensor, the full "
                    f"shape and type of cache leaf `{full[r.shape, r.dtype]}` — the cache "
                    "update lowered to a full rebuild instead of an in-place commit")


def audit_dequant(prog: XrayProgram,
                  threshold: int = DEQUANT_THRESHOLD) -> Iterable[Finding]:
    """Outside the entry points no op outputs a float buffer of a quantized
    weight's logical shape (or of its groups) at or above ``threshold``
    bytes."""
    if not prog.weight_sigs:
        return
    for node in prog.record.glue():
        for r in node.outputs:
            # a weight's shape, or its groups (..., n / GS, GS) before the
            # dequantized values are viewed back
            shapes = (r.shape, r.shape[:-2] + (r.shape[-2] * r.shape[-1],)) \
                if len(r.shape) >= 2 else (r.shape,)
            if r.dtype in _FLOAT_DTYPES and any(sh in prog.weight_sigs for sh in shapes) \
                    and r.nbytes >= threshold:
                yield Finding(
                    "xray-dequant", prog.path, prog.line,
                    f"{prog.name}: {node.name} materializes a weight-shaped float buffer "
                    f"{list(r.shape)} {str(r.dtype).replace('torch.', '')} "
                    f"({r.nbytes / 1e6:.1f} MB) — quantized weights must dequantize inside "
                    "the kernel and stream at storage width, never as a standalone "
                    "dequantized copy")


def bytes_headroom(prog: XrayProgram) -> float:
    """Recorded bytes over the model's, less one."""
    return prog.record.hbm_bytes() / prog.expected_bytes - 1.0


def audit_bytes(prog: XrayProgram, rtol: float = BYTES_RTOL) -> Iterable[Finding]:
    """The recorded bytes of a decode step agree with the registry nbytes
    model within ``rtol``."""
    if prog.expected_bytes is None:
        return
    delta = bytes_headroom(prog)
    if abs(delta) <= rtol:
        return
    got = prog.record.hbm_bytes()
    top = max(prog.record.nodes,
              key=lambda n: n.weight_bytes + sum(r.nbytes for r in n.outputs + n.cache))
    yield Finding(
        "xray-bytes", prog.path, prog.line,
        f"{prog.name}: the recorded decode moves {got / 1e6:.1f} MB/step but the registry "
        f"nbytes model says {prog.expected_bytes / 1e6:.1f} MB ({delta:+.1%}, tolerance "
        f"±{rtol:.0%}) — the {prog.fmt} format is not streaming weights at its declared "
        f"width; top contributor {top.name}"
        + (f" `{top.weight}`" if top.weight else ""))


def audit_collectives(prog: XrayProgram) -> Iterable[Finding]:
    """No collective the placement does not predict (none on one rank);
    the projection entry points number what ``bounds.decode_projections``
    counts at the program's depth."""
    for node in prog.record.collectives():
        base = node.name.split(".")[1] if "." in node.name else node.name
        if base not in prog.expected_collectives:
            yield Finding(
                "xray-collective", prog.path, prog.line,
                f"{prog.name}: unexpected collective {node.name} — the placement predicts "
                f"{sorted(prog.expected_collectives) or 'no collectives'} for this program; "
                "an unpredicted collective means an input lost its placement and is "
                "gathered again every step")
    if prog.expected_projections is not None:
        got = len(prog.record.projections())
        if got != prog.expected_projections:
            yield Finding(
                "xray-collective", prog.path, prog.line,
                f"{prog.name}: {got} projection entry points where num_layers="
                f"{prog.num_layers} gives {prog.expected_projections} — the layer loop lost "
                "or repeated iterations; per-step traffic no longer scales the way the "
                "roofline model assumes")


# ---------------------------------------------------------------------------
# checkers
# ---------------------------------------------------------------------------

class _XrayChecker(BaseChecker):
    """Shared plumbing: build/reuse the program catalog, wrap failures."""

    audit: Callable = None
    only_kinds: tuple = ()

    def __init__(self, catalog_fn: Callable[[], Iterable[XrayProgram]] | None = None):
        self._catalog_fn = catalog_fn or catalog

    def check_project(self, root: str) -> Iterable[Finding]:
        try:
            progs = list(self._catalog_fn())
        except Exception as e:  # noqa: BLE001 — surface as a finding, not a crash
            yield Finding(self.id, XRAY_ANCHOR, 1,
                          f"xray program catalog failed to build: {e!r}")
            return
        for prog in progs:
            if self.only_kinds and prog.kind not in self.only_kinds:
                continue
            yield from type(self).audit(prog)


class XrayDonationChecker(_XrayChecker):
    id = "xray-donation"
    description = ("serving programs write their cache/pool leaves in place and never "
                   "rebuild a cache-shaped buffer")
    audit = staticmethod(audit_donation)


class XrayDequantChecker(_XrayChecker):
    id = "xray-dequant"
    description = ("decode never materializes a weight-shaped float buffer outside the "
                   "kernels: quantized weights stream at storage width")
    audit = staticmethod(audit_dequant)
    only_kinds = ("decode",)


class XrayBytesChecker(_XrayChecker):
    id = "xray-bytes"
    description = ("recorded bytes per decode step match the registry nbytes model within "
                   "tolerance for every quant preset")
    audit = staticmethod(audit_bytes)
    only_kinds = ("decode",)


class XrayCollectiveChecker(_XrayChecker):
    id = "xray-collective"
    description = ("decode runs only the collectives the placement predicts and "
                   "4 L + 1 projections at depth L")
    audit = staticmethod(audit_collectives)


# ---------------------------------------------------------------------------
# the card halves (chip_smoke.py phase 14)
# ---------------------------------------------------------------------------

def _projection_node(name: str) -> bool:
    from repro_torch.analysis.program import kernel_signature

    base = kernel_signature(name)[0]
    return "gqmv" in base or "gqmm" in base


def card_audit(prog, engine, *, name: str) -> tuple[list[str], dict]:
    """The four audits' card halves on a captured decode program of
    ``engine`` -> (failures, what was read). ``prog.inputs["cache"]`` is
    its cache (or pool); the weights are ``engine.params``."""
    from repro_torch.analysis.program import card_record
    from repro_torch.core.policy import leaf_class
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.core.tree import tensor_items, tree_items
    from repro_torch.kernels import bounds

    cfg, params = engine.cfg, engine.params
    cache = prog.inputs["cache"]
    bad: list[str] = []
    crec = card_record(prog, params, layers=cfg.num_layers)
    nodes = crec.nodes

    # donation: the cache keeps its addresses across a replay; the pool holds
    # less than one cache leaf
    before = {p: t.data_ptr() for p, t in tensor_items(cache)}
    prog.replay()
    torch.cuda.synchronize()
    moved = [p for p, t in tensor_items(cache) if t.data_ptr() != before[p]]
    if moved:
        bad.append(f"xray-donation {name}: cache leaves {moved} moved across a replay")
    leaf_min = min(t.numel() * t.element_size() for _, t in tensor_items(cache))
    if prog.pool_bytes >= leaf_min:
        bad.append(f"xray-donation {name}: the graph pool holds {prog.pool_bytes} bytes, at "
                   f"least one cache leaf ({leaf_min}): a copy of the cache would fit there")

    # dequant: no argument points at a pool block of a weight slice's float size
    qleaves = [(p, leaf) for p, leaf in tree_items(params) if isinstance(leaf, QuantizedTensor)]
    big = max(DEQUANT_THRESHOLD, min(2 * leaf.logical_shape[-1] * leaf.logical_shape[-2]
                                     for _, leaf in qleaves))
    for i, span, _, direct in crec.reads("pool"):
        if direct and span.nbytes >= big:
            bad.append(f"xray-dequant {name}: {nodes[i].name[:60]} reads a {span.nbytes}-byte "
                       f"graph-pool block, the size of a dequantized weight (>= {big})")

    # bytes: the slices of each weight tensor that kernel nodes read. A
    # struct argument's words may hold stale host bytes, so only pointer
    # arguments count the readers of a quantized slice
    users: dict[tuple[str, int], set[int]] = {}
    slices: dict[str, set[int]] = {}
    spans = {}
    for i, span, off, direct in crec.reads("weight"):
        slices.setdefault(span.name, set()).add(off // span.slice_bytes)
        if direct:
            users.setdefault((span.name, off // span.slice_bytes), set()).add(i)
        spans[span.name] = span
    read = 0.0
    for path, span in spans.items():
        leaf = path.rsplit("/", 1)[0]
        if leaf_class(leaf) == "embed" and path.endswith(("/qvalues", "/scales")):
            read += span.nbytes * BYTES_BATCH / _table_rows(params, leaf)    # gathered rows
        else:
            read += span.slice_bytes * len(slices[path])
    for p, leaf in qleaves:
        if leaf_class(p) == "embed":
            continue
        slices = spans[f"{p}/qvalues"].nbytes // spans[f"{p}/qvalues"].slice_bytes \
            if f"{p}/qvalues" in spans else 1
        for part in ("qvalues", "scales"):
            counts = [len(users.get((f"{p}/{part}", k), ())) for k in range(slices)]
            if counts != [1] * slices:
                bad.append(f"xray-bytes {name}: `{p}/{part}`'s {slices} slices read by "
                           f"{counts} kernel nodes (each once expected)")
        if not all(_projection_node(nodes[i].name)
                   for (path, _), us in users.items() if path == f"{p}/qvalues" for i in us):
            bad.append(f"xray-bytes {name}: `{p}` read by a kernel that is no GQMV/GQMM "
                       "(not at storage width)")
    terms = expected_decode_bytes(params, cache, BYTES_BATCH, cfg.vocab_size,
                                  BYTES_CACHE_LEN)[1]
    model_w = terms["quantized"] + terms["embed"] + terms["float"]
    if abs(read / model_w - 1.0) > BYTES_RTOL:
        bad.append(f"xray-bytes {name}: kernel nodes read {read / 1e6:.2f} MB of weights, the "
                   f"registry model {model_w / 1e6:.2f} MB")

    # collectives: no NCCL node; 4 L + 1 projection nodes
    nccl = [n.name for n in nodes if "nccl" in n.name.lower()]
    if nccl:
        bad.append(f"xray-collective {name}: NCCL kernel nodes {nccl[:3]}")
    proj = sum(_projection_node(n.name) for n in nodes)
    want = sum(c for _, _, c in bounds.decode_projections(cfg))
    if proj != want:
        bad.append(f"xray-collective {name}: {proj} GQMV/GQMM nodes, {want} expected at "
                   f"{cfg.num_layers} layers")
    stats = {"kernel_nodes": len(nodes), "projection_nodes": proj, "expected_projections": want,
             "weight_bytes_read": read, "registry_weight_bytes": model_w,
             "pool_bytes": prog.pool_bytes, "cache_leaf_min_bytes": leaf_min}
    return bad, stats


def _table_rows(params, leaf: str) -> int:
    """Rows of the quantized table at ``leaf`` (a '/'-joined path)."""
    node = params
    for k in leaf.split("/"):
        node = node[k]
    return node.logical_shape[0]
