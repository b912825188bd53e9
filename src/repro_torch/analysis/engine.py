"""The port's static-analysis framework: its own copy of the checker
protocol and AST helpers of ``repro/analysis/engine.py`` (the port imports
nothing of the reference package).

A checker implements ``check_file(path, tree, source)`` and yields
:class:`Finding`s; :func:`run_analysis` runs checkers over files and
directories. The reference's allowlist file and project-level checkers
are not ported: the port's checkers run on its own files only.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable

SEVERITIES = ("error", "warning")

# directories never scanned
SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules", ".venv"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect: checker id, anchor (file:line:col), severity, message."""

    checker: str
    path: str            # repo-relative posix path
    line: int
    message: str
    severity: str = "error"
    col: int = 0

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    @property
    def anchor(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.severity}[{self.checker}] {self.message}"


class BaseChecker:
    """No-op default; a checker overrides ``check_file``."""

    id = "base"
    description = ""

    def check_file(self, path: str, tree: ast.AST, source: str) -> Iterable[Finding]:
        return ()


def iter_python_files(paths: list[str], root: str) -> list[str]:
    """Expand files/directories into a sorted list of .py paths."""
    out: list[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap):
            out.append(ap)
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = [d for d in sorted(dirnames) if d not in SKIP_DIRS]
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py"))
    return out


def run_analysis(checkers: list, paths: list[str], root: str) -> list[Finding]:
    """Every checker over ``paths``, findings sorted by (path, line,
    checker); a file that fails to parse is itself a finding."""
    findings: list[Finding] = []
    for fp in iter_python_files(paths, root):
        rel = os.path.relpath(fp, root).replace(os.sep, "/")
        try:
            with open(fp, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding("parse", rel, getattr(e, "lineno", 0) or 0, str(e)))
            continue
        for c in checkers:
            findings.extend(c.check_file(rel, tree, source))
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains; '' when not a
    plain dotted path (calls, subscripts)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def assigned_names(target: ast.AST) -> list[str]:
    """Flatten assignment targets (incl. tuple unpacks) into plain names."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: list[str] = []
        for elt in target.elts:
            out.extend(assigned_names(elt))
        return out
    return []
