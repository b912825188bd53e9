"""Captured programs: the port's counterpart of the reference's ``jax.jit``
over ``generate`` (``repro/serving/engine.py``) and over the scheduler
rounds (``repro/serving/core.py``, ``repro/serving/paged.py``).

A :class:`Program` is one step function over static buffers, captured once
per signature as a ``torch.cuda.CUDAGraph`` and replayed: the prefill of a
``generate`` signature or of a serve's bucket, one decode step, replayed
once per step, and one speculative verify step (``serving/spec.py``),
replayed once per verify step. Each engine keeps its programs and their
static state in a :class:`GraphCache`, keyed like the reference's ``_generate_jit`` plus what
the port reads at call time: the kernel implementation in force
(``kernels/ops.impl_scope``) and the ``core/flags.py`` values. So a program
captured on the CUDA kernels never replays under ``impl_scope("plain")``.

The state a program reads and writes (tokens, positions as device tensors,
the ``done`` / ``live`` / ``stopped`` flags, block tables, KV caches) lives
in buffers allocated outside any capture and updated in place; a program's
outputs live in the engine's graph pool, which every program of the engine
shares, and are copied out (:meth:`Program.run`) before another program
replays. On the card a program is built by one warm-up run on clones of
its inputs, on a side stream (first-use set-up such as a kernel's
shared-memory opt-in happens there), then captured; a capture or replay
that fails raises, and nothing falls back to eager execution. On the CPU,
and on the card inside :func:`eager`, the same plumbing runs the step
function eagerly on the same static buffers.

Launch counts (the kernels' ``LAUNCHES``): a warm-up's launches and the
capture's (which launch nothing) are taken back out; each replay adds the
counts its capture recorded, so a replayed step counts what an eager step
counts.

A captured program is read through the CUDA driver API: :func:`census`
counts its nodes and edges, :func:`kernel_nodes` lists its kernel nodes
with their names, launch configurations and argument values (the card
halves of ``analysis/xray.py`` and ``analysis/launch_contract.py`` read
them), and :func:`captured` gives every captured program still alive.

While spans are recorded (``serving/spans.py``) every :meth:`Program.replay`
is a ``program.replay`` span carrying the program's name.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import time
import weakref
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from repro_torch.core import flags
from repro_torch.core.tree import tree_map
from repro_torch.kernels import flash_attn, gqmv, ops, paged_attn, rmsnorm_quant
from repro_torch.serving import spans

__all__ = ["BUILD_LISTENERS", "GraphCache", "KernelNode", "Program", "captured", "census",
           "eager", "kernel_nodes"]

# every kernel wrapper's launch counts
_COUNTS = (gqmv.LAUNCHES, paged_attn.LAUNCHES, flash_attn.LAUNCHES, rmsnorm_quant.LAUNCHES)

# callables (name, key) told of every program build (analysis/recompile.py)
BUILD_LISTENERS: list[Callable[[str, tuple], None]] = []

_MODE = {"eager": False}

# every captured program still alive (the launch contract's card half walks them)
_CAPTURED: weakref.WeakSet = weakref.WeakSet()


def captured() -> list["Program"]:
    """The captured programs still alive, in no particular order."""
    return [p for p in list(_CAPTURED) if p.graph is not None]


@contextlib.contextmanager
def eager():
    """Run the programs entered in this scope eagerly on their own static
    buffers (keyed apart from the captured ones): the comparison run on the
    card. The CPU always runs programs so."""
    prev = _MODE["eager"]
    _MODE["eager"] = True
    try:
        yield
    finally:
        _MODE["eager"] = prev


def _snapshot() -> list[dict[str, int]]:
    return [dict(c) for c in _COUNTS]


def _restore(snap: list[dict[str, int]]) -> None:
    for counts, saved in zip(_COUNTS, snap):
        counts.update(saved)


def _clone(tree):
    return None if tree is None else tree_map(torch.clone, tree)


class Program:
    """One step function ``fn(**inputs)`` over static ``inputs`` (tensors or
    dicts of them, updated in place by ``fn``); ``outputs`` is what ``fn``
    returned at capture (static, overwritten by each replay)."""

    def __init__(self, name: str, key: tuple, fn: Callable, inputs: dict,
                 device: torch.device, pool, eager_mode: bool):
        self.name, self.key, self.fn, self.inputs = name, key, fn, inputs
        self.device, self.pool, self.eager = device, pool, eager_mode
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.launches: list[tuple[dict, str, int]] = []   # counts one replay adds
        self.warmup_s = self.capture_s = 0.0
        self.pool_bytes = 0

    @torch.inference_mode()
    def build(self) -> None:
        """Warm up on clones of the inputs, then capture (on the card)."""
        if self.eager:
            return
        dev = self.device
        snap = _snapshot()
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            scratch = _clone(self.inputs)
            self.fn(**scratch)
        main.wait_stream(side)
        del scratch
        _restore(snap)              # warm-up launches are build work, not the path's
        t1 = time.perf_counter()
        torch.cuda.empty_cache()    # the capture empties it too: reserved bytes compare
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)       # kept for census()
        # no garbage collection during the capture: collecting a dropped
        # engine's graph there resets it, which ends the capture
        # (cudaErrorStreamCaptureInvalidated); the capture itself no longer
        # collects first
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.outputs = self.fn(**self.inputs)
        finally:
            if gc_was_on:
                gc.enable()
        graph.instantiate()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = _snapshot()
        self.launches = [(counts, k, after[i][k] - snap[i][k])
                         for i, counts in enumerate(_COUNTS) for k in counts
                         if after[i][k] != snap[i][k]]
        _restore(snap)              # a capture launches nothing
        self.graph = graph
        _CAPTURED.add(self)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    @torch.inference_mode()
    def load(self, **values) -> None:
        """Copy host or device values into the static inputs (host arrays
        are staged at once, so the caller may reuse them)."""
        for name, v in values.items():
            dst = self.inputs[name]
            if isinstance(v, (bool, int, float)):
                dst.fill_(v)
            else:
                src = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
                    v, np.ndarray) else v
                dst.copy_(src, non_blocking=True)

    @torch.inference_mode()
    def replay(self):
        """One run of the program; returns its static outputs."""
        sp = spans.begin("program.replay", program=self.name) if spans.ON else None
        if self.graph is None:
            self.outputs = self.fn(**self.inputs)
        else:
            self.graph.replay()
            for counts, k, n in self.launches:
                counts[k] += n
        if sp is not None:
            spans.end(sp)
        return self.outputs

    @torch.inference_mode()
    def copies(self):
        """Copies of the last run's outputs, which no later replay of this or
        another program overwrites."""
        return _clone(self.outputs)

    def run(self):
        """One run; returns copies of its outputs."""
        self.replay()
        return self.copies()


class _Edge(ctypes.Structure):
    # CUgraphEdgeData of the CUDA driver API
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


class _KernelParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 of the CUDA driver API
    _fields_ = [("func", ctypes.c_void_p),
                *((f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                                "block_y", "block_z", "smem")),
                ("kernel_params", ctypes.POINTER(ctypes.c_void_p)),
                ("extra", ctypes.POINTER(ctypes.c_void_p)),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA driver error {rc}")


def _graph_nodes(prog: Program) -> tuple[ctypes.CDLL, ctypes.c_void_p, list[int], list[int]]:
    """(the driver, the graph, its nodes, each node's type) of a captured
    program (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    if prog.graph is None:
        raise ValueError(f"{prog.name}: not a captured program")
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(prog.graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        kinds.append(kind.value)
    return cu, graph, list(nodes), kinds


@dataclasses.dataclass(frozen=True)
class KernelNode:
    """One kernel node of a captured program: the kernel's (mangled) name,
    its launch configuration, and each argument's bytes (empty where the
    driver does not say how the arguments are laid out)."""

    name: str
    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    smem: int
    args: tuple[bytes, ...]

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    def values(self) -> list[int]:
        """Each argument as an unsigned little-endian integer (a pointer
        argument's address)."""
        return [int.from_bytes(a, "little") for a in self.args]


def _param_layout(cu, func: ctypes.c_void_p, kern: ctypes.c_void_p) -> list[tuple[int, int]]:
    """(offset, size) of each argument of a kernel, from
    ``cuFuncGetParamInfo`` (or ``cuKernelGetParamInfo``): the index past the
    last one returns an error."""
    get = cu.cuFuncGetParamInfo if func.value else cu.cuKernelGetParamInfo
    handle = func if func.value else kern
    out = []
    off, size = ctypes.c_size_t(0), ctypes.c_size_t(0)
    while get(handle, ctypes.c_size_t(len(out)), ctypes.byref(off), ctypes.byref(size)) == 0:
        out.append((off.value, size.value))
    return out


def kernel_nodes(prog: Program) -> list[KernelNode]:
    """The kernel nodes of a captured program, in the graph's node order:
    each kernel's function (``cuGraphKernelNodeGetParams``), its name
    (``cuFuncGetName``), grid, block and dynamic shared memory, and its
    arguments' values (``cuFuncGetParamInfo``'s layout over the node's
    ``kernelParams`` or ``extra`` buffer)."""
    cu, _, nodes, kinds = _graph_nodes(prog)
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
        cu.cuGraphKernelNodeGetParams
    out = []
    for node, kind in zip(nodes, kinds):
        if kind != 0:       # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = _KernelParams()
        _check(get_params(ctypes.c_void_p(node), ctypes.byref(p)), "cuGraphKernelNodeGetParams")
        func, kern = ctypes.c_void_p(p.func), ctypes.c_void_p(p.kern)
        name = ctypes.c_char_p()
        if func.value:
            _check(cu.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
        else:
            _check(cu.cuKernelGetName(ctypes.byref(name), kern), "cuKernelGetName")
        layout = _param_layout(cu, func, kern)
        args: list[bytes] = []
        if layout and p.kernel_params:
            args = [ctypes.string_at(p.kernel_params[i], size)
                    for i, (_, size) in enumerate(layout)]
        elif layout and p.extra:
            # CU_LAUNCH_PARAM_BUFFER_POINTER (1) then its address, ..., END (0)
            i, buf = 0, None
            while p.extra[i]:
                if p.extra[i] == 1:
                    buf = p.extra[i + 1]
                i += 2
            if buf:
                args = [ctypes.string_at(buf + off, size) for off, size in layout]
        out.append(KernelNode(name.value.decode(), (p.grid_x, p.grid_y, p.grid_z),
                              (p.block_x, p.block_y, p.block_z), p.smem, tuple(args)))
    return out


def census(prog: Program) -> dict[str, int]:
    """Nodes, kernel nodes, edges and programmatic edges (a programmatic
    dependent launch kept as such) of a captured program's graph, read
    through the CUDA driver API (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphGetEdges_v2``)."""
    cu, graph, nodes, kinds = _graph_nodes(prog)
    e = ctypes.c_size_t(0)
    _check(cu.cuGraphGetEdges_v2(graph, None, None, None, ctypes.byref(e)), "cuGraphGetEdges_v2")
    src, dst, data = (ctypes.c_void_p * e.value)(), (ctypes.c_void_p * e.value)(), \
        (_Edge * e.value)()
    _check(cu.cuGraphGetEdges_v2(graph, src, dst, data, ctypes.byref(e)), "cuGraphGetEdges_v2")
    # CU_GRAPH_NODE_TYPE_KERNEL = 0; CU_GRAPH_DEPENDENCY_TYPE_PROGRAMMATIC = 1
    return {"nodes": len(nodes), "kernel_nodes": kinds.count(0), "edges": e.value,
            "programmatic_edges": sum(d.type == 1 for d in data)}


class GraphCache:
    """An engine's programs and their static state, by signature. ``stats``
    gives builds, warm-up and capture seconds and graph-pool bytes by
    program name."""

    def __init__(self, device: torch.device, config):
        self.device = device
        # the model config (arch included) is part of every signature, so no
        # program is ever shared across configs
        self.config = config
        self.programs: dict[tuple, Program] = {}
        self.states: dict[tuple, dict] = {}
        self.last: dict[str, Program] = {}     # the program of each name run last
        self._pool = None

    def _full_key(self, name: str, key: tuple) -> tuple:
        eager_mode = self.device.type != "cuda" or _MODE["eager"]
        return (name, self.config, key, ops.scope_impl(), tuple(sorted(flags.FLAGS.items())),
                eager_mode)

    def state(self, name: str, key: tuple, make: Callable[[], dict]) -> dict:
        """Static buffers for ``(name, key)`` under the current impl, flags
        and mode, made by ``make()`` once."""
        full = self._full_key(name, key)
        if full not in self.states:
            self.states[full] = make()
        return self.states[full]

    def program(self, name: str, key: tuple, fn: Callable, make_inputs: Callable[[], dict]
                ) -> Program:
        """The program ``name`` for ``key`` (which must determine every
        static buffer ``make_inputs`` returns and everything ``fn`` closes
        over), built at first use."""
        full = self._full_key(name, key)
        prog = self.programs.get(full)
        if prog is None:
            eager_mode = full[-1]
            if not eager_mode and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            prog = Program(name, full, fn, make_inputs(), self.device, self._pool, eager_mode)
            prog.build()
            self.programs[full] = prog
            for listener in BUILD_LISTENERS:
                listener(name, full)
        self.last[name] = prog
        return prog

    def stats(self) -> dict[str, dict]:
        out: dict[str, dict] = defaultdict(lambda: {"builds": 0, "captured": 0,
                                                    "warmup_s": 0.0, "capture_s": 0.0,
                                                    "pool_bytes": 0})
        for p in self.programs.values():
            s = out[p.name]
            s["builds"] += 1
            s["captured"] += p.graph is not None
            s["warmup_s"] += p.warmup_s
            s["capture_s"] += p.capture_s
            s["pool_bytes"] += p.pool_bytes
        return dict(out)
