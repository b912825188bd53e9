"""adapter-lifecycle checker: the CacheAdapter alloc/free contract, statically
(the port's copy of ``repro/analysis/adapter_lifecycle.py``).

The scheduling core (serving/core.py) owns one cache lifecycle (alloc on
admit, insert on prefill, commit per round, free on finish) and every
``CacheAdapter`` subclass re-implements some slice of it. The repro-san
shadow tracker (analysis/shadow.py) catches violations at run time; this
checker catches the structural ones before a request ever runs:

1. **alloc without free**: an adapter class whose own body calls
   ``.alloc(...)`` anywhere outside ``on_finish`` must define an
   ``on_finish`` that calls ``.free(...)``. An adapter that reserves pool
   blocks but never returns them leaks the pool dry one finished request
   at a time.

2. **concrete adapter without san_state**: a class declaring a concrete
   ``kind`` (a string other than ``"abstract"``, plain or annotated
   assign) must define ``san_state`` in its own body. The sanitizer
   mirrors whatever the adapter allocates through ``san_state()``; an
   inherited stub means a new allocator ships with no shadow coverage.

3. **serve loop without end_serve**: a function that contains a ``while``
   loop and calls ``.begin_serve()`` must also call ``.end_serve()``, and
   must not ``return`` from inside the ``while``: an early return skips the
   adapter's pool accounting and the sanitizer's finalize audit.
   (Straight-line code, such as a test that pokes one adapter method, has
   no serve loop and is exempt.)

Adapter classes are recognized by a base name ending in ``Adapter`` or an
own-body ``kind`` string assignment; helper classes (pools, trackers) are
not audited.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import BaseChecker, Finding

ABSTRACT_KIND = "abstract"


def _own_kind(cls: ast.ClassDef) -> str | None:
    """The class's own-body ``kind = "<str>"`` value (Assign or AnnAssign),
    or None when not declared locally."""
    for stmt in cls.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            target, value = stmt.target, stmt.value
        else:
            continue
        if (isinstance(target, ast.Name) and target.id == "kind"
                and isinstance(value, ast.Constant)
                and isinstance(value.value, str)):
            return value.value
    return None


def _is_adapter_class(cls: ast.ClassDef) -> bool:
    if any(isinstance(b, (ast.Name, ast.Attribute))
           and _base_name(b).endswith("Adapter") for b in cls.bases):
        return True
    return cls.name.endswith("Adapter") or _own_kind(cls) is not None


def _base_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _method_calls(node: ast.AST) -> Iterable[ast.Call]:
    """All ``<expr>.<attr>(...)`` calls under ``node``."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            yield n


def _shallow_walk(stmts: list[ast.stmt]) -> Iterable[ast.AST]:
    """Walk statements without descending into nested function/class
    definitions or lambdas (their bodies run in another lifecycle)."""
    stack: list[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class AdapterLifecycleChecker(BaseChecker):
    id = "adapter-lifecycle"
    description = ("CacheAdapter subclasses: alloc implies an on_finish that "
                   "frees; concrete kinds define san_state; serve loops "
                   "reach end_serve")

    # -- rules 1 + 2: per adapter class --------------------------------------
    def _check_class(self, path: str, cls: ast.ClassDef) -> Iterable[Finding]:
        methods = {stmt.name: stmt for stmt in cls.body
                   if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))}

        # rule 1: .alloc( outside on_finish => on_finish containing .free(
        alloc_site = None
        for name, fn in methods.items():
            if name == "on_finish":
                continue
            for call in _method_calls(fn):
                if call.func.attr == "alloc":
                    alloc_site = (name, call)
                    break
            if alloc_site:
                break
        if alloc_site is not None:
            name, call = alloc_site
            on_finish = methods.get("on_finish")
            frees = on_finish is not None and any(
                c.func.attr == "free" for c in _method_calls(on_finish))
            if not frees:
                yield Finding(
                    self.id, path, call.lineno,
                    f"{cls.name}.{name} allocates (`.alloc(...)`) but the "
                    "class defines no on_finish that frees: finished "
                    "requests leak their blocks and the pool drains — pair "
                    "every alloc with a `.free(...)` in on_finish",
                    col=call.col_offset)

        # rule 2: concrete kind => own-body san_state
        kind = _own_kind(cls)
        if (kind is not None and kind != ABSTRACT_KIND
                and "san_state" not in methods):
            yield Finding(
                self.id, path, cls.lineno,
                f"{cls.name} declares kind={kind!r} but no own-body "
                "san_state: the repro-san shadow tracker cannot mirror this "
                "adapter's allocator — define san_state() returning "
                "{'pool': ..., 'table': ...} (None for slot-only adapters)",
                col=cls.col_offset)

    # -- rule 3: serve-loop lifecycle ----------------------------------------
    def _check_serve_fn(self, path: str,
                        fn: ast.FunctionDef) -> Iterable[Finding]:
        shallow = list(_shallow_walk(fn.body))
        begins = [n for n in shallow
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "begin_serve"]
        whiles = [n for n in shallow if isinstance(n, ast.While)]
        if not begins or not whiles:
            return
        ends = any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "end_serve" for n in shallow)
        if not ends:
            yield Finding(
                self.id, path, begins[0].lineno,
                f"`{fn.name}` serves (begin_serve + while loop) but never "
                "calls end_serve: pool accounting and the sanitizer finalize "
                "audit are skipped", col=begins[0].col_offset)
        for loop in whiles:
            for n in _shallow_walk(loop.body):
                if isinstance(n, ast.Return):
                    yield Finding(
                        self.id, path, n.lineno,
                        f"return inside `{fn.name}`'s serve while-loop: "
                        "early exit skips end_serve (and the sanitizer "
                        "leak audit) — break out and return after the loop",
                        col=n.col_offset)

    def check_file(self, path, tree, source) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and _is_adapter_class(node):
                yield from self._check_class(path, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_serve_fn(path, node)
