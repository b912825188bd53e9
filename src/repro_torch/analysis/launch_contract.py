"""launch-contract: the launch invariants of every hand-written kernel in
``csrc/`` (counterpart of ``repro/analysis/pallas_contract.py``).

The reference checks each ``pallas_call``'s grid, block specs and VMEM
budget before any kernel runs. A CUDA launch has its own contract, and a
launch that breaks it fails on the card only (an invalid configuration, or
a grid that silently drops work). The checker reads each ``csrc/*.cu``
(comments stripped, function-like macros expanded) and holds every
``kernel<<<grid, block, smem, stream>>>`` and ``cudaLaunchKernelEx`` site
to five rules:

- **block threads <= 1024**, the block's expression resolved through the
  file's ``constexpr`` names, struct members (``KV::threads``), local
  ``const`` names and the values a template parameter is instantiated with;
- **grid y and z bounded**: each is a constant <= 65535, or its run-time
  names are compared against a bound <= 65535 in an ``if (...) return``
  (or a predicate such as ``bad_args``) on a call path from an
  ``extern "C"`` entry to the launch;
- **dynamic shared memory from a ``*smem_bytes`` helper** with a Python
  mirror in ``kernels/`` (:data:`MIRRORS`);
- **the opt-in above 48 KB**: a launch whose mirror can pass 48 KB at any
  config's shapes is preceded by ``cudaFuncSetAttribute(...,
  cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` for the same kernel,
  in the launching function or a helper it calls first;
- each file's ``kMaxSmem`` equals ``kernels/cuda_build.MAX_SMEM``.

The run-time half (:func:`mirror_cases`) evaluates every mirror at the
shapes of all 11 configs and every weight format and holds each to
``MAX_SMEM``; the card half (:func:`card_contract`) holds every kernel node
of a captured program to the block and grid limits, and a hand-written
kernel's dynamic shared memory to its mirror at that node's arguments.
"""

from __future__ import annotations

import ast
import operator
import os
import re
from pathlib import Path
from typing import Iterable

from repro_torch.analysis.engine import BaseChecker, Finding

MAX_THREADS = 1024
MAX_GRID_YZ = 65535
DEFAULT_SMEM = 48 * 1024

# a csrc helper -> its Python mirror ("module.function" under kernels/)
MIRRORS = {
    "stream_smem_bytes": "gqmv.stream_smem_bytes",
    "stream_block_smem_bytes": "gqmv.stream_smem_bytes",
    "small_smem_bytes": "gqmv.small_smem_bytes",
    "large_smem_bytes": "gqmv.large_smem_bytes",
    "f32_smem_bytes": "flash_attn.f32_smem_bytes",
    "mma_smem_bytes": "flash_attn.mma_smem_bytes",
    "bwd_mma_smem_bytes": "flash_attn.bwd_smem_bytes",
    "bwd_f32_smem_bytes": "flash_attn.bwd_smem_bytes",
    "smem_bytes": "paged_attn.smem_bytes",
    "combine_smem_bytes": "paged_attn.combine_smem_bytes",
    "first_smem_bytes": "rmsnorm_quant.first_smem_bytes",
}


# ---------------------------------------------------------------------------
# reading a .cu file
# ---------------------------------------------------------------------------

def strip_comments(text: str) -> str:
    """Comments blanked out, every newline kept (line numbers hold)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group())
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _close(text: str, i: int, pair: str = "()") -> int:
    """Index of the bracket closing the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == pair[0]:
            depth += 1
        elif text[j] == pair[1]:
            depth -= 1
            if depth == 0:
                return j
    raise ValueError(f"unbalanced {pair} from offset {i}")


def split_top(s: str, sep: str = ",", angles: bool = True) -> list[str]:
    """``s`` split at ``sep`` outside brackets (and, with ``angles``, outside
    template angle brackets: not where ``>>`` may be a shift)."""
    opens, closes = ("([{<", ")]}>") if angles else ("([{", ")]}")
    out, depth, cur = [], 0, ""
    for c in s:
        if c in opens:
            depth += 1
        elif c in closes:
            depth -= 1
        if c == sep and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += c
    if cur.strip():
        out.append(cur.strip())
    return out


def expand_macros(text: str) -> str:
    """Function-like and object-like ``#define``s expanded line by line, each
    with the definition in force at that line (``##`` pasted); directive
    lines blanked, so line numbers hold."""
    lines = text.split("\n")
    macros: dict[str, tuple[list[str] | None, str]] = {}
    i = 0
    while i < len(lines):
        m = re.match(r"\s*#\s*define\s+(\w+)(\(([^)]*)\))?\s?(.*)$", lines[i])
        if m:
            body, j = m.group(4), i
            lines[i] = ""
            while body.endswith("\\"):
                j += 1
                body = body[:-1] + " " + lines[j]
                lines[j] = ""
            params = [p.strip() for p in m.group(3).split(",")] if m.group(2) else None
            macros[m.group(1)] = (params, body)
            i = j + 1
            continue
        u = re.match(r"\s*#\s*undef\s+(\w+)", lines[i])
        if u:
            macros.pop(u.group(1), None)
            lines[i] = ""
        elif macros:
            lines[i] = _expand_line(lines[i], macros)
        i += 1
    return "\n".join(lines)


def _expand_line(line: str, macros: dict) -> str:
    for _ in range(8):              # macros that expand to macros
        changed = False
        for name, (params, body) in macros.items():
            pos = 0
            while m := re.search(rf"\b{name}\b", line[pos:]):
                start, end = pos + m.start(), pos + m.end()
                if params is None:
                    rep = body
                else:
                    k = end
                    while k < len(line) and line[k] in " \t":
                        k += 1
                    if k >= len(line) or line[k] != "(":
                        pos = end
                        continue
                    close = _close(line, k)
                    rep = body
                    for p, a in zip(params, split_top(line[k + 1:close])):
                        rep = re.sub(rf"\b{p}\b", a, rep)
                    end = close + 1
                rep = re.sub(r"\s*##\s*", "", rep)
                line = line[:start] + rep + line[end:]
                pos = start + len(rep)
                changed = True
        if not changed:
            break
    return line


class Function:
    """A function definition: name, template parameter names, parameter
    names, and body (with its offset in the text)."""

    def __init__(self, name, tparams, params, body, start):
        self.name, self.tparams, self.params = name, tparams, params
        self.body, self.start = body, start


class Source:
    """One .cu file, read for the contract."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = expand_macros(strip_comments(text))
        self.functions: dict[str, list[Function]] = {}
        self.consts: dict[str, str] = {}            # name -> expression
        self.members: dict[str, list[str]] = {}     # "Struct::name" -> expressions
        self.fn_returns: dict[str, set[str]] = {}   # "Struct::fn" -> kernel names
        self._scan(self.text, 0, None)
        for m in re.finditer(r"\bconstexpr\s+(?:int|size_t|unsigned|long|bool)\s+(\w+)\s*=\s*"
                             r"([^;]+);", self.text):
            self.consts.setdefault(m.group(1), m.group(2).strip())

    def line(self, offset: int) -> int:
        return self.text.count("\n", 0, offset) + 1

    def _scan(self, text: str, base: int, struct: str | None) -> None:
        i, head_start = 0, 0
        while i < len(text):
            c = text[i]
            if c in ";}":
                head_start = i + 1
            elif c == "{":
                head = text[head_start:i]
                end = _close(text, i, "{}")
                inner = text[i + 1:end]
                if re.search(r"\bnamespace\b[\w\s]*$", head) or re.search(
                        r'extern\s+"C"\s*$', head):
                    self._scan(inner, base + i + 1, struct)
                elif m := re.search(r"\b(?:struct|class)\s+(\w+)[^()]*$", head):
                    self._struct(m.group(1), inner)
                elif head.rstrip().endswith(")") or re.search(r"\)\s*(const|noexcept)\s*$",
                                                               head):
                    self._function(head, inner, base + i + 1)
                i, head_start = end + 1, end + 1
                continue
            i += 1

    def _struct(self, name: str, body: str) -> None:
        for m in re.finditer(r"static\s+constexpr\s+\w+\s+([^;]+);", body):
            for decl in split_top(m.group(1)):
                if "=" in decl:
                    k, v = decl.split("=", 1)
                    self.members.setdefault(f"{name}::{k.strip()}", []).append(v.strip())
        for m in re.finditer(r"static\s+auto\s+(\w+)\s*\(\s*\)\s*\{\s*return\s+(\w+)", body):
            self.fn_returns.setdefault(f"{name}::{m.group(1)}", set()).add(m.group(2))

    def _function(self, head: str, body: str, start: int) -> None:
        close = len(head.rstrip()) - 1
        while head[close] != ")":
            close -= 1
        depth, j = 0, close
        while j >= 0:
            depth += head[j] == ")"
            depth -= head[j] == "("
            if depth == 0:
                break
            j -= 1
        m = re.search(r"(\w+)\s*$", head[:j])
        if not m or m.group(1) in ("if", "for", "while", "switch", "return"):
            return
        tparams: list[str] = []
        t = re.search(r"template\s*<(.*)>\s*[^<>]*$", head[:j], re.S)
        if t:
            tparams = [p.split()[-1] for p in split_top(t.group(1)) if p.split()]
        params = [re.findall(r"\w+", p)[-1] for p in split_top(head[j + 1:close])
                  if re.findall(r"\w+", p)]
        self.functions.setdefault(m.group(1), []).append(
            Function(m.group(1), tparams, params, body, start))

    # -- values -----------------------------------------------------------
    def instantiations(self, fname: str, index: int) -> list[str]:
        """The ``index``-th template argument of every ``fname<...>`` use."""
        out = []
        for m in re.finditer(rf"\b{fname}\s*<", self.text):
            k = m.end() - 1
            depth, j = 0, k
            while j < len(self.text):
                depth += self.text[j] == "<"
                depth -= self.text[j] == ">"
                if depth == 0:
                    break
                j += 1
            args = split_top(self.text[k + 1:j])
            if index < len(args):
                out.append(args[index])
        return out

    def values(self, expr: str, fn: Function | None, seen: frozenset = frozenset()) -> set[int]:
        """Every integer ``expr`` can take (empty when one of its names cannot
        be resolved)."""
        expr = expr.strip()
        expr = re.sub(r"static_cast<\w+>|\((?:size_t|int|long|unsigned|long long)\)", "", expr)
        expr = re.sub(r"sizeof\(float\)", "4", expr)
        m = re.fullmatch(r"dim3\((.*)\)", expr)
        if m:
            parts = split_top(m.group(1))
            prod = {1}
            for p in parts:
                vs = self.values(p, fn, seen)
                if not vs:
                    return set()
                prod = {a * b for a in prod for b in vs}
            return prod
        names = sorted(set(re.findall(r"[A-Za-z_][\w:]*", expr)) - {"true", "false"})
        if not names:
            v = _eval(expr)
            return {v} if v is not None else set()
        name = names[0]
        if name in seen:
            return set()
        options = self.resolve(name, fn)
        out: set[int] = set()
        for opt in options:
            sub = re.sub(rf"(?<![\w:]){re.escape(name)}(?![\w:])", f"({opt})", expr)
            out |= self.values(sub, fn, seen | {name})
        return out

    def resolve(self, name: str, fn: Function | None) -> list[str]:
        """Expressions ``name`` may stand for: a local ``const`` / ``constexpr``
        in ``fn``, a template parameter's instantiated values, a
        ``using`` alias's struct member, a file constant."""
        if fn is not None:
            m = re.search(rf"\b(?:const|constexpr)\s+[\w:<>]+\s+{name}\s*=\s*([^;]+);", fn.body)
            if m:
                return [m.group(1)]
            if name in fn.tparams:
                idx = fn.tparams.index(name)
                return sorted(set(self.instantiations(fn.name, idx)))
            if "::" in name:
                alias, member = name.split("::", 1)
                u = re.search(rf"\busing\s+{alias}\s*=\s*(\w+)", fn.body)
                if u:
                    return self.members.get(f"{u.group(1)}::{member}", [])
        if name in self.consts:
            return [self.consts[name]]
        return self.members.get(name, [])


_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod, ast.LShift: operator.lshift,
        ast.RShift: operator.rshift}


def _eval(expr: str) -> int | None:
    """An integer C expression of literals (``/`` truncating), or None."""
    expr = re.sub(r"(\d+)[uUlL]+\b", r"\1", expr).replace("/", "//")
    try:
        node = ast.parse(expr, mode="eval").body
    except SyntaxError:
        return None

    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
            return _OPS[type(n.op)](ev(n.left), ev(n.right))
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        raise ValueError
    try:
        return ev(node)
    except (ValueError, ZeroDivisionError):
        return None


# ---------------------------------------------------------------------------
# launch sites
# ---------------------------------------------------------------------------

class Launch:
    def __init__(self, fn: Function, offset: int, kernel: str, grid: str, block: str,
                 smem: str):
        self.fn, self.offset = fn, offset
        self.kernel, self.grid, self.block, self.smem = kernel, grid, block, smem


# a call: a name, template arguments, and (as in a macro's `(RUN)(args)`) a
# closing parenthesis before the arguments
_CALL = r"\b(\w+)\s*(<[^;()]*>)?\s*\)?\s*\("


def _base(expr: str) -> str:
    m = re.match(r"\s*&?\s*([\w:]+)", expr)
    return m.group(1) if m else expr.strip()


def _cfg_field(src: Source, fn: Function, var: str, field: str, before: int) -> str | None:
    """The last ``var.field = ...`` before ``before`` in ``fn`` (or in the
    helper whose result ``var`` is)."""
    hits = [m for m in re.finditer(rf"\b{var}\.{field}\s*=\s*([^;]+);", fn.body)
            if m.start() < before]
    if hits:
        return hits[-1].group(1)
    m = re.search(rf"\b{var}\s*=\s*(\w+)\s*\(", fn.body)
    if m and m.group(1) in src.functions:
        helper = src.functions[m.group(1)][0]
        h = re.search(rf"\.{field}\s*=\s*([^;]+);", helper.body)
        return h.group(1) if h else None
    return None


def launches(src: Source) -> list[Launch]:
    out = []
    for fns in src.functions.values():
        for fn in fns:
            for m in re.finditer(r"<<<", fn.body):
                k = m.start()
                j = k
                while j > 0 and fn.body[j - 1] not in ";{}\n":
                    j -= 1
                kernel = fn.body[j:k].strip()
                end = fn.body.index(">>>", k)
                cfg = split_top(fn.body[k + 3:end], angles=False) + ["0", "0"]
                out.append(Launch(fn, fn.start + k, kernel, cfg[0], cfg[1], cfg[2]))
            for m in re.finditer(r"cudaLaunchKernelEx\s*\(", fn.body):
                close = _close(fn.body, m.end() - 1)
                args = split_top(fn.body[m.end():close])
                var = _base(args[0])
                fields = [_cfg_field(src, fn, var, f, m.start())
                          for f in ("gridDim", "blockDim", "dynamicSmemBytes")]
                out.append(Launch(fn, fn.start + m.start(), args[1], fields[0] or "",
                                  fields[1] or "", fields[2] or "0"))
    return sorted(out, key=lambda launch: launch.offset)


def _kernel_bases(src: Source, fn: Function, expr: str, depth: int = 0) -> set[str]:
    """The kernel names an expression names: a kernel template, a local
    ``auto`` alias, ``K::fn()`` (every struct's ``fn``), or a parameter of
    ``fn`` (each caller's argument)."""
    name = _base(expr)
    m = re.search(rf"\b(?:const\s+)?auto\s+{name}\s*=\s*([\w:]+)", fn.body)
    if m:
        return {m.group(1)}
    if "::" in name:
        member = name.split("::", 1)[1]
        return {k for key, ks in src.fn_returns.items() if key.endswith("::" + member)
                for k in ks}
    if name in fn.params and depth < 3:
        idx = fn.params.index(name)
        out = set()
        for callers in src.functions.values():
            for caller in callers:
                for c in re.finditer(rf"\b{fn.name}\s*(?:<[^;()]*>)?\s*\(", caller.body):
                    args = split_top(caller.body[c.end():_close(caller.body, c.end() - 1)])
                    if idx < len(args):
                        out |= _kernel_bases(src, caller, args[idx], depth + 1)
        return out
    return {name}


def _opt_in_kernels(src: Source, fn: Function, before: int, depth: int = 0) -> set[str]:
    """Kernels ``fn`` opts in above 48 KB before offset ``before`` of its
    body: its own ``cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize``
    calls and those of the helpers it calls first."""
    out: set[str] = set()
    body = fn.body[:before]
    for m in re.finditer(r"cudaFuncSetAttribute\s*\(", body):
        args = split_top(body[m.end():_close(fn.body, m.end() - 1)])
        if len(args) >= 2 and "MaxDynamicSharedMemorySize" in args[1]:
            out |= _kernel_bases(src, fn, args[0])
    if depth < 2:
        for m in re.finditer(_CALL, body):
            if m.group(1) in src.functions and m.group(1) != fn.name:
                for helper in src.functions[m.group(1)]:
                    out |= _opt_in_kernels(src, helper, len(helper.body), depth + 1)
    return out


def _runtime_names(src: Source, fn: Function, expr: str) -> set[str]:
    """The names of ``expr`` that are run-time values: not constants,
    template parameters or struct members."""
    out = set()
    for name in set(re.findall(r"[A-Za-z_][\w:]*", expr)) - {"true", "false", "dim3"}:
        if name in fn.tparams or name in src.consts or name in src.members or "::" in name:
            continue
        m = re.search(rf"\b(?:const|constexpr)\s+[\w:<>]+\s+{name}\s*=\s*([^;]+);", fn.body)
        if m:
            sub = _runtime_names(src, fn, m.group(1))
            if not sub:             # a local compile-time constant
                continue
            out |= sub
        out.add(name)
    return out


def _guards(src: Source, fn: Function) -> list[tuple[set[str], int | None]]:
    """(names compared, the bound) of each ``X > N`` / ``X >= N`` in an
    ``if (...) return`` of ``fn``, and in the predicates it calls there."""
    out = []
    for m in re.finditer(r"\bif\s*\(", fn.body):
        close = _close(fn.body, m.end() - 1)
        if not re.match(r"\s*return\b", fn.body[close + 1:]):
            continue
        cond = fn.body[m.end():close]
        out += _comparisons(src, fn, cond)
        for c in re.finditer(r"\b(\w+)\s*\(", cond):
            for pred in src.functions.get(c.group(1), []):
                r = re.search(r"\breturn\s+([^;]+);", pred.body)
                if not r:
                    continue
                args = split_top(cond[c.end():_close(cond, c.end() - 1)])
                expr = r.group(1)
                for p, a in zip(pred.params, args):
                    expr = re.sub(rf"\b{p}\b", f"({a})", expr)
                out += _comparisons(src, fn, expr)
    return out


def _comparisons(src: Source, fn: Function, cond: str) -> list[tuple[set[str], int | None]]:
    out = []
    for term in re.split(r"\|\||&&", cond):
        m = re.match(r"\s*(.+?)\s*(>=|>)\s*(.+?)\s*$", term.strip().strip("()"))
        if not m:
            continue
        bounds = src.values(m.group(3), fn)
        out.append((_runtime_names(src, fn, m.group(1)), max(bounds) if bounds else None))
    return out


def _paths_to(src: Source, target: Function) -> list[Function]:
    """Every function on a call path from an ``extern "C"`` entry to
    ``target`` (``target`` included)."""
    callers: dict[str, set[str]] = {}
    for fns in src.functions.values():
        for f in fns:
            for c in re.finditer(_CALL, f.body):
                if c.group(1) in src.functions:
                    callers.setdefault(c.group(1), set()).add(f.name)
    up, stack = {target.name}, [target.name]
    while stack:
        for c in callers.get(stack.pop(), ()):
            if c not in up:
                up.add(c)
                stack.append(c)
    return [f for name in up for f in src.functions.get(name, [])]


def check_source(rel: str, text: str, mirror_max: dict[str, int] | None = None
                 ) -> Iterable[Finding]:
    """The contract's findings for one .cu file (``rel`` its repo-relative
    path); ``mirror_max`` is each helper's most bytes over the configs'
    shapes (:func:`mirror_maxima`)."""
    from repro_torch.kernels.cuda_build import MAX_SMEM

    src = Source(rel, text)
    mirror_max = mirror_max if mirror_max is not None else mirror_maxima()
    m = re.search(r"\bkMaxSmem\s*=\s*([^;]+);", src.text)
    if m and _eval(m.group(1)) != MAX_SMEM:
        yield Finding("launch-contract", rel, src.line(m.start()),
                      f"kMaxSmem = {m.group(1).strip()} but the port's one MAX_SMEM "
                      f"(kernels/cuda_build.py) is {MAX_SMEM}")
    for launch in launches(src):
        fn, line = launch.fn, src.line(launch.offset)
        kname = "/".join(sorted(_kernel_bases(src, fn, launch.kernel)))
        threads = src.values(launch.block, fn)
        if not threads:
            yield Finding("launch-contract", rel, line,
                          f"{kname}: block `{launch.block}` does not resolve to constants")
        elif max(threads) > MAX_THREADS:
            yield Finding("launch-contract", rel, line,
                          f"{kname}: block `{launch.block}` takes up to {max(threads)} threads, "
                          f"more than {MAX_THREADS}")
        grid = launch.grid.strip()
        g = re.fullmatch(r"dim3\((.*)\)", grid)
        if not g:
            d = re.search(rf"\bdim3\s+{re.escape(grid)}\s*\(([^;]*)\)\s*;", fn.body)
            g = d
        dims = split_top(g.group(1)) if g else [grid]
        for axis, expr in zip("yz", dims[1:]):
            vals = src.values(expr, fn)
            if vals and max(vals) <= MAX_GRID_YZ:
                continue
            names = _runtime_names(src, fn, expr)
            ok = bool(names) and any(
                names <= gnames and bound is not None and bound <= MAX_GRID_YZ
                for f in _paths_to(src, fn) for gnames, bound in _guards(src, f))
            if not ok:
                yield Finding("launch-contract", rel, line,
                              f"{kname}: grid {axis} `{expr}` is neither a constant <= "
                              f"{MAX_GRID_YZ} nor guarded (> {MAX_GRID_YZ} -> error return) on "
                              "the path from its extern \"C\" entry")
        smem = launch.smem.strip()
        if _eval(smem) == 0:
            continue
        exprs = [smem]
        if re.fullmatch(r"[\w:]+", smem):
            exprs = src.resolve(smem, fn) or [smem]
        helpers = []
        for e in exprs:
            h = re.match(r"\s*(\w*smem_bytes)\s*(<[^>]*>)?\s*\(", e)
            if not h:
                yield Finding("launch-contract", rel, line,
                              f"{kname}: dynamic shared memory `{smem}` is not given by a "
                              "*smem_bytes helper with a Python mirror in kernels/")
                continue
            helpers.append(h.group(1))
            if h.group(1) not in MIRRORS or h.group(1) not in src.functions:
                yield Finding("launch-contract", rel, line,
                              f"{kname}: shared-memory helper `{h.group(1)}` has no Python "
                              "mirror in kernels/ (launch_contract.MIRRORS)")
        if any(mirror_max.get(h, 0) > DEFAULT_SMEM for h in helpers):
            opted = _opt_in_kernels(src, fn, launch.offset - fn.start)
            if not _kernel_bases(src, fn, launch.kernel) & opted:
                yield Finding("launch-contract", rel, line,
                              f"{kname}: dynamic shared memory can pass 48 KB "
                              f"({max(mirror_max.get(h, 0) for h in helpers)} bytes) but no "
                              "cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...) for "
                              "this kernel precedes the launch")


# ---------------------------------------------------------------------------
# the run-time half: every mirror at every config's shapes
# ---------------------------------------------------------------------------

def mirror_cases():
    """(helper, arguments, bytes) of every mirror at the shapes of the 11
    configs, every weight format, both GQMM designs' tiles, every head dim
    and the paged pools' element widths at block sizes 8 and 16."""
    import torch

    from repro_torch.kernels import bounds, flash_attn, gqmv, paged_attn, rmsnorm_quant
    from repro_torch.models.registry import ARCH_IDS, load_config

    fmts = tuple(gqmv.WEIGHT_FORMATS)
    for arch in ARCH_IDS:
        cfg = load_config(arch)
        for m, n, _ in bounds.projections(cfg):
            gs = bounds.group_size(cfg, n)
            for fmt in fmts:
                if gqmv.gqmv_design(n, fmt) == "stream":
                    helper = "stream_block_smem_bytes" if fmt in gqmv.STREAM_X_BYTES \
                        else "stream_smem_bytes"
                    yield helper, (arch, fmt, n, gs), gqmv.stream_smem_bytes(n, n // gs, fmt)
                # the small design's tiles where the dispatch picks it (it
                # takes the large design where they would not fit)
                for tiles8 in sorted({gqmv.gqmm_design(b, m, n, gs, fmt)[1]
                                      for b in range(2, gqmv.SMALL_MAX_B + 1)
                                      if gqmv.gqmm_design(b, m, n, gs, fmt)[0] == "small"}):
                    yield "small_smem_bytes", (arch, fmt, tiles8, n, gs), \
                        gqmv.small_smem_bytes(tiles8, n, n // gs)
            if n <= rmsnorm_quant.MAX_N:
                yield "first_smem_bytes", (arch, n), rmsnorm_quant.first_smem_bytes(n)
        if cfg.num_kv_heads and cfg.num_heads % cfg.num_kv_heads == 0:
            g, hd = cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim
            if hd in paged_attn.HEAD_DIMS:
                for bs in (8, 16):
                    for elt, quant in ((4, False), (2, False), (1, True)):
                        yield "smem_bytes", (arch, g, hd, bs, elt, quant), \
                            paged_attn.smem_bytes(g, hd, bs, elt, quant)
                yield "combine_smem_bytes", (arch, g, paged_attn.MAX_SPLITS), \
                    paged_attn.combine_smem_bytes(g, paged_attn.MAX_SPLITS)
    for fmt in fmts:
        for rows in (gqmv.WIDE_ROWS, gqmv.NARROW_ROWS):
            yield "large_smem_bytes", (fmt, rows), gqmv.large_smem_bytes(fmt, rows)
    for hd in flash_attn.HEAD_DIMS:
        yield "f32_smem_bytes", (hd,), flash_attn.f32_smem_bytes(hd)
        yield "mma_smem_bytes", (hd,), flash_attn.mma_smem_bytes(hd)
        for dq in (False, True):
            yield "bwd_mma_smem_bytes", (hd, dq), flash_attn.bwd_smem_bytes(hd, dq)
            yield "bwd_f32_smem_bytes", (hd, dq), flash_attn.bwd_smem_bytes(hd, dq,
                                                                            torch.float32)


def mirror_maxima() -> dict[str, int]:
    out: dict[str, int] = {}
    for helper, _, nbytes in mirror_cases():
        out[helper] = max(out.get(helper, 0), nbytes)
    return out


class LaunchContractChecker(BaseChecker):
    id = "launch-contract"
    description = ("every csrc/ launch: block <= 1024 threads, grid y/z bounded or guarded, "
                   "shared memory from a mirrored *smem_bytes helper, the opt-in above 48 KB, "
                   "kMaxSmem == MAX_SMEM; every mirror <= MAX_SMEM at every config's shapes")

    def __init__(self, csrc: str | os.PathLike | None = None):
        self.csrc = Path(csrc) if csrc is not None else None

    def check_project(self, root: str) -> Iterable[Finding]:
        from repro_torch.kernels.cuda_build import MAX_SMEM

        csrc = self.csrc or Path(root) / "src" / "repro_torch" / "csrc"
        maxima: dict[str, int] = {}
        for helper, args, nbytes in mirror_cases():
            maxima[helper] = max(maxima.get(helper, 0), nbytes)
            if nbytes > MAX_SMEM:
                yield Finding(self.id, "src/repro_torch/analysis/launch_contract.py", 1,
                              f"mirror {MIRRORS[helper]} at {args} gives {nbytes} bytes, more "
                              f"than MAX_SMEM {MAX_SMEM}")
        for path in sorted(csrc.glob("*.cu")):
            try:
                rel = path.relative_to(root).as_posix()
            except ValueError:
                rel = path.as_posix()
            yield from check_source(rel, path.read_text(), maxima)


# ---------------------------------------------------------------------------
# the card half: the kernel nodes of captured programs
# ---------------------------------------------------------------------------

def card_mirror(name: str, values: list[int]) -> int | None:
    """The dynamic shared memory a hand-written kernel node must have, from
    its mirror at the node's template and run-time arguments (None for a
    kernel with no csrc/ helper)."""
    import torch

    from repro_torch.analysis.program import kernel_signature
    from repro_torch.kernels import flash_attn, gqmv, paged_attn, rmsnorm_quant

    base, targs = kernel_signature(name)

    def lit(i):
        return int(targs[i])

    fmt_of = {"StreamInt8": "int8", "StreamFp8": "fp8", "StreamInt4": "int4",
              "StreamInt3": "int3", "TcInt8": "int8", "TcInt4": "int4", "TcInt3": "int3",
              "TcFp8": "fp8"}
    i32 = [v & 0xFFFFFFFF for v in values]
    if base in ("gqmm_kernel", "rmsnorm_quant_rows_kernel", "empty_kernel",
                "flash_bwd_delta_kernel", "flash_bwd_group_sum_kernel"):
        return 0
    if base == "gqmv_stream_kernel":             # (wq, ws, xq, xs, out, m, n, pieces, rows)
        n = i32[6]
        return gqmv.stream_smem_bytes(n, n >> lit(1), fmt_of[targs[0]])
    if base == "gqmv_stream_block_kernel":       # (wq, ws, xq, xs, out, m, n)
        n = i32[6]
        return gqmv.stream_smem_bytes(n, n >> lit(1), fmt_of[targs[0]])
    if base == "gqmm_small_kernel":              # (wq, ws, xq, xs, out, b, m, n, gs_log2)
        n = i32[7]
        return gqmv.small_smem_bytes(lit(1), n, n >> i32[8])
    if base == "gqmm_mma_kernel":
        return gqmv.large_smem_bytes(fmt_of[targs[0]], 32 * lit(1))
    if base == "flash_attn_f32_kernel":
        return flash_attn.f32_smem_bytes(lit(0))
    if base == "flash_attn_mma_kernel":
        return flash_attn.mma_smem_bytes(lit(1))
    if base == "flash_bwd_mma_kernel":
        return flash_attn.bwd_smem_bytes(lit(1), targs[2] == "1")
    if base == "flash_bwd_f32_kernel":
        return flash_attn.bwd_smem_bytes(lit(0), targs[1] == "1", torch.float32)
    if base == "paged_attn_kernel":              # (q, kp, vp, ks, vs, table, pos, kn, vn,
        elt = {"float": 4, "__nv_bfloat16": 2, "signed char": 1, "__nv_fp8_e4m3": 1}
        g, bs = i32[13], i32[14]                 #  mask, out, part, kv, g, bs, ...)
        pool = targs[1] if targs[1] != "?" else targs[0]    # S1_: the pool's type is T's
        return paged_attn.smem_bytes(g, lit(3), bs, elt[pool], targs[2] == "1")
    if base == "paged_attn_combine_kernel":      # (part, out, g, nsplit)
        return paged_attn.combine_smem_bytes(i32[2], i32[3])
    if base == "rmsnorm_quant_first_kernel":     # (x, w, q, scales, n, gs, eps)
        return rmsnorm_quant.first_smem_bytes(i32[4])
    return None


def card_contract(nodes, tag: str) -> tuple[list[str], int]:
    """Every kernel node: block <= 1024 threads, grid y/z <= 65535, dynamic
    shared memory <= MAX_SMEM and, for a hand-written kernel, equal to its
    mirror -> (failures, hand-written nodes held to a mirror)."""
    from repro_torch.kernels.cuda_build import MAX_SMEM

    bad, mirrored = [], 0
    for node in nodes:
        if node.threads > MAX_THREADS or max(node.grid[1:]) > MAX_GRID_YZ \
                or node.smem > MAX_SMEM:
            bad.append(f"launch-contract {tag}: {node.name[:80]} grid {node.grid} block "
                       f"{node.block} smem {node.smem}")
        want = card_mirror(node.name, node.values()) if node.args else None
        if want is not None:
            mirrored += 1
            if want != node.smem:
                bad.append(f"launch-contract {tag}: {node.name[:80]} has {node.smem} bytes of "
                           f"dynamic shared memory, its mirror {want}")
    return bad, mirrored
