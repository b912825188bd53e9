"""host-sync checker for the port: the counterpart of
``repro/analysis/host_sync.py`` for PyTorch.

LlamaF's pipeline never lets the host block the accelerator (§IV). The
reference holds its serving loops to one device round trip per scheduler
round; the port, whose rounds replay captured programs
(``serving/graphs.py``), is held to the same. Two rules:

1. **No sync inside a captured function.** A host read of a device value
   cannot be recorded into a CUDA graph: capture fails, or the value read
   at capture is baked in. A captured function is one passed as the step
   function (third argument or ``fn=``) to a ``*.program(...)`` call.

2. **The per-round budget** (scheduler files only): inside a ``while``
   serve loop each path may make at most ``max_per_path`` (default 2: one
   admission transfer and one round transfer) device round trips, and no
   function of those files may make one inside a ``for`` loop: a per-step
   or per-item sync serializes the pipeline step by step (the form
   ``bool((live & (tok == eos)).any())`` in a round's step loop). Paths are
   split on ``if ...: ... continue`` arms, as in the reference.

Sync sites: ``torch.cuda.synchronize``; ``.cpu()`` and ``.item()``;
``.tolist()`` / ``.numpy()`` on a device value (one site for a chain such
as ``x.cpu().numpy()``); and ``bool()`` / ``int()`` / ``float()`` of a
device value. A device value is a name bound from a ``torch.*`` call, a
method call on a device value or a call with one as an argument,
arithmetic or an index of one, a ``decode_round`` / ``prefill_insert`` /
``verify_round`` result or a program's ``replay()``, or a name ending
``_d``; in a captured function every parameter is one too. A name bound
from a sync is a host value. The speculative loops (``SchedulerCore.serve``'s
verify round, ``InferenceEngine._generate_spec``) are held to one transfer
a verify step by the same rules.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterable

from repro_torch.analysis.engine import BaseChecker, Finding, assigned_names, dotted_name

SYNC_FUNCS = {"torch.cuda.synchronize"}
SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
IMPLICIT_CASTS = {"bool", "int", "float"}
HOST_TORCH = {"torch.from_numpy"}                  # torch calls that make host tensors
HOST_FUNCS = {"len", "isinstance", "type", "id", "print", "str", "repr"}
DEVICE_RESULTS = {"decode_round", "prefill_insert", "verify_round", "replay"}

DEFAULT_LOOP_FILES = (
    "*serving/batching.py",
    "*serving/core.py",
    "*serving/paged.py",
    "*serving/engine.py",
)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_scope(node: ast.AST):
    """ast.walk without descending into nested function bodies."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, _FUNCS):
            stack.extend(ast.iter_child_nodes(n))


def _is_device(node: ast.AST, tainted: set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in tainted or node.id.endswith("_d")
    if isinstance(node, ast.Call):
        if _sync_kind(node, tainted):
            return False                          # fetched: a host value
        name = dotted_name(node.func)
        if name.startswith("torch.") and not name.startswith("torch.cuda."):
            return name not in HOST_TORCH
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in DEVICE_RESULTS or _is_device(node.func.value, tainted)):
            return True
        # a function of device values: model.decode(tok), sample(logits)
        return name not in HOST_FUNCS and any(_is_device(a, tainted) for a in node.args)
    if isinstance(node, ast.BinOp):
        return _is_device(node.left, tainted) or _is_device(node.right, tainted)
    if isinstance(node, ast.UnaryOp):
        return _is_device(node.operand, tainted)
    if isinstance(node, ast.Compare):
        return any(_is_device(n, tainted) for n in (node.left, *node.comparators))
    if isinstance(node, ast.Subscript):
        return _is_device(node.value, tainted)
    if isinstance(node, ast.IfExp):
        return _is_device(node.body, tainted) or _is_device(node.orelse, tainted)
    return False


def _sync_kind(node: ast.Call, tainted: set[str]) -> str | None:
    """A short label if the call is a host sync, else None."""
    name = dotted_name(node.func)
    if name in SYNC_FUNCS:
        return name
    if name in IMPLICIT_CASTS:
        if len(node.args) == 1 and _is_device(node.args[0], tainted):
            return f"{name}(<device value>)"
        return None
    if isinstance(node.func, ast.Attribute) and node.func.attr in SYNC_METHODS:
        recv = node.func.value
        if dotted_name(recv).split(".")[0] in ("np", "numpy", "math"):
            return None
        if isinstance(recv, ast.Call) and _sync_kind(recv, tainted):
            return None                           # x.cpu().numpy(): one transfer
        if node.func.attr in ("cpu", "item") or _is_device(recv, tainted):
            return f".{node.func.attr}()"
    return None


def _taint(fn: ast.AST, seed: set[str] = frozenset()) -> set[str]:
    """Names of ``fn``'s own scope bound to device values."""
    tainted = set(seed)
    assigns = [n for n in _walk_scope(fn) if isinstance(n, (ast.Assign, ast.AugAssign,
                                                             ast.AnnAssign))]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if node.value is None or not _is_device(node.value, tainted):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for name in assigned_names(t):
                    if name not in tainted:
                        tainted.add(name)
                        changed = True
    return tainted


def _sites(stmts, tainted: set[str]) -> list[tuple[ast.Call, str, bool]]:
    """(call, label, inside a for loop) for every sync under ``stmts``, not
    descending into nested function bodies."""
    out = []

    def visit(node, in_for):
        if isinstance(node, _FUNCS):
            return
        if isinstance(node, ast.Call):
            kind = _sync_kind(node, tainted)
            if kind is not None:
                out.append((node, kind, in_for))
        inner = in_for or isinstance(node, (ast.For, ast.AsyncFor))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    for s in stmts:
        visit(s, False)
    return out


def _captured_defs(tree: ast.AST) -> list[ast.FunctionDef]:
    """Function defs passed as the step function of a ``*.program(...)`` call."""
    by_name: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
    out, seen = [], set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and dotted_name(node.func).split(".")[-1]
                == "program"):
            continue
        fn = node.args[2] if len(node.args) > 2 else next(
            (k.value for k in node.keywords if k.arg == "fn"), None)
        if isinstance(fn, ast.Name):
            for fd in by_name.get(fn.id, ()):
                if id(fd) not in seen:
                    seen.add(id(fd))
                    out.append(fd)
    return out


def _ends_in_continue(body: list[ast.stmt]) -> bool:
    return bool(body) and isinstance(body[-1], ast.Continue)


class HostSyncChecker(BaseChecker):
    id = "host-sync"
    description = ("no host sync inside a captured function; at most max_per_path per "
                   "serve-loop path and none inside a for loop in the scheduler files")

    def __init__(self, loop_files=DEFAULT_LOOP_FILES, max_per_path: int = 2):
        self.loop_files = loop_files
        self.max_per_path = max_per_path

    def _check_captured(self, path, tree) -> Iterable[Finding]:
        for fn in _captured_defs(tree):
            params = {a.arg for a in (*fn.args.posonlyargs, *fn.args.args,
                                      *fn.args.kwonlyargs)}
            for node, kind, _ in _sites(fn.body, _taint(fn, params)):
                yield Finding(self.id, path, node.lineno,
                              f"host sync {kind} inside captured `{fn.name}`: a CUDA graph "
                              "cannot record a host read of a device value",
                              col=node.col_offset)

    def _check_loops(self, path, tree) -> Iterable[Finding]:
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            tainted = _taint(fn)
            for node, kind, in_for in _sites(fn.body, tainted):
                if in_for:
                    yield Finding(self.id, path, node.lineno,
                                  f"host sync {kind} inside a for loop of `{fn.name}`: a "
                                  "per-step round trip serializes the pipeline; move the "
                                  "value to the round's one transfer", col=node.col_offset)
            for loop in _walk_scope(fn):
                if isinstance(loop, ast.While):
                    yield from self._check_while(path, fn, loop, tainted)

    def _check_while(self, path, fn, loop, tainted) -> Iterable[Finding]:
        # one path per `if ...: ... continue` arm, plus the fall-through
        paths: list[list] = []
        prefix: list = []
        for stmt in loop.body:
            if isinstance(stmt, ast.If) and _ends_in_continue(stmt.body):
                paths.append(prefix + _sites(stmt.body, tainted))
                prefix = prefix + _sites(stmt.orelse, tainted)
            else:
                prefix = prefix + _sites([stmt], tainted)
        paths.append(prefix)
        for sites in paths:
            sites = [s for s in sites if not s[2]]      # for-loop sites flagged above
            if len(sites) > self.max_per_path:
                node, kind, _ = sites[self.max_per_path]
                yield Finding(self.id, path, node.lineno,
                              f"{len(sites)} host syncs on one path of `{fn.name}`'s serve "
                              f"loop (budget {self.max_per_path}): one admission transfer "
                              f"and one round transfer; extra site is {kind}",
                              col=node.col_offset)

    def check_file(self, path, tree, source) -> Iterable[Finding]:
        yield from self._check_captured(path, tree)
        if any(fnmatch.fnmatch(path, g) for g in self.loop_files):
            yield from self._check_loops(path, tree)
