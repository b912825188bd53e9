"""Captures, statically and at run time: the port's counterpart of the
reference's ``repro/analysis/recompile.py`` (``RecompileChecker`` and
``JitTraceCounter``).

The serving programs are built to capture ONCE per signature
(``serving/graphs.py``: a ``generate`` signature's prefill and decode step,
a serve's decode step, its prefill once per group size and bucket length).
A capture per call, from a key that varies where it should not, would
multiply a step's latency by the capture time.

- :class:`CaptureGuardChecker` (``capture-guard``, static): flags a
  ``torch.cuda.graph(``, ``torch.cuda.CUDAGraph(`` or
  ``<...>graphs.program(`` inside a loop body (a fresh capture every
  iteration), and an unhashable literal (a list, dict or set display) in a
  program key (``GraphCache.program`` / ``GraphCache.state``'s ``key``),
  which cannot key the cache at all.
- :class:`CaptureCounter` (run time) counts program builds per name while
  it is active, with the full key of each.
"""

from __future__ import annotations

import ast
from collections import Counter, defaultdict
from typing import Iterable

from repro_torch.analysis.engine import BaseChecker, Finding, dotted_name
from repro_torch.serving import graphs

_CAPTURES = ("torch.cuda.graph", "torch.cuda.CUDAGraph")
_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)


def _graph_cache_call(node: ast.Call, method: str) -> bool:
    """``<...>graphs.<method>(...)``: a GraphCache's method, by the name the
    port gives every GraphCache (``engine.graphs``)."""
    f = node.func
    return isinstance(f, ast.Attribute) and f.attr == method and \
        dotted_name(f.value).split(".")[-1] == "graphs"


def _is_capture(node: ast.Call) -> bool:
    return dotted_name(node.func) in _CAPTURES or _graph_cache_call(node, "program")


def _unhashable_in(expr: ast.AST) -> ast.AST | None:
    """A list/dict/set display in ``expr`` outside any call (``tuple([...])``
    is hashable)."""
    if isinstance(expr, _UNHASHABLE):
        return expr
    if isinstance(expr, ast.Call):
        return None
    for child in ast.iter_child_nodes(expr):
        hit = _unhashable_in(child)
        if hit is not None:
            return hit
    return None


class CaptureGuardChecker(BaseChecker):
    id = "capture-guard"
    description = ("no CUDA-graph capture or GraphCache.program inside a loop body; no "
                   "unhashable literal in a program key")

    def check_file(self, path, tree, source) -> Iterable[Finding]:
        yield from self._captures_in_loops(path, tree)
        yield from self._unhashable_keys(path, tree)

    def _captures_in_loops(self, path, tree) -> Iterable[Finding]:
        class V(ast.NodeVisitor):
            def __init__(self):
                self.hits: list[ast.Call] = []
                self._loop = 0

            def visit_For(self, node):
                self._loop += 1
                self.generic_visit(node)
                self._loop -= 1

            visit_While = visit_AsyncFor = visit_For

            def visit_FunctionDef(self, node):
                # the body runs when called, not in the enclosing loop
                loop, self._loop = self._loop, 0
                for stmt in node.body:
                    self.visit(stmt)
                self._loop = loop

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                loop, self._loop = self._loop, 0
                self.generic_visit(node)
                self._loop = loop

            def visit_Call(self, node):
                if self._loop and _is_capture(node):
                    self.hits.append(node)
                self.generic_visit(node)

        v = V()
        v.visit(tree)
        for node in v.hits:
            yield Finding(
                self.id, path, node.lineno,
                f"{dotted_name(node.func) or 'a capture'}(...) inside a loop body: every "
                "iteration captures a fresh graph — build the program once (GraphCache keys "
                "it by signature) and replay it in the loop", col=node.col_offset)

    def _unhashable_keys(self, path, tree) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not (
                    _graph_cache_call(node, "program") or _graph_cache_call(node, "state")):
                continue
            key = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "key"), None)
            hit = _unhashable_in(key) if key is not None else None
            if hit is not None:
                yield Finding(
                    self.id, path, hit.lineno,
                    f"unhashable {type(hit).__name__.lower()} literal in the key of "
                    f"{dotted_name(node.func)}(...): a program key must be hashable (use a "
                    "tuple), or the cache cannot hold the program", col=hit.col_offset)


class CaptureCounter:
    """Counts program builds per program name while active.

    >>> with CaptureCounter() as cc:
    ...     engine.generate(batch, 8)
    ...     engine.generate(batch, 8)
    >>> cc.counts["generate.decode"]
    1
    """

    def __init__(self):
        self.counts: Counter[str] = Counter()
        self.keys: dict[str, list[tuple]] = defaultdict(list)

    def _record(self, name: str, key: tuple) -> None:
        self.counts[name] += 1
        self.keys[name].append(key)

    def __enter__(self):
        graphs.BUILD_LISTENERS.append(self._record)
        return self

    def __exit__(self, *exc):
        graphs.BUILD_LISTENERS.remove(self._record)
        return False

    def total(self) -> int:
        return sum(self.counts.values())

    def assert_builds(self, name: str, expected: int) -> None:
        got = self.counts.get(name, 0)
        if got != expected:
            raise AssertionError(
                f"`{name}` built {got}x, expected exactly {expected}: a rebuild means a "
                f"key varied per call (all counts: {dict(self.counts)})")
