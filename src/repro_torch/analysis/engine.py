"""The port's static-analysis framework: its own copy of the checker
protocol, allowlist and AST helpers of ``repro/analysis/engine.py`` (the
port imports nothing of the reference package).

Two checker shapes exist, as in the reference:

- **file checkers** implement ``check_file(path, tree, source)`` and run on
  every scanned ``*.py`` (AST only, no imports);
- **project checkers** implement ``check_project(root)`` and run once per
  invocation; they may import the port's modules (the format registry, the
  model registry) to hold live objects to their declared contracts.

:func:`run_analysis` runs both. Deliberate exceptions live in an allowlist
file (the CLI's default ``.repro-torch-lint-allow`` at the repo root), one
finding pattern per line,

    <checker-id>  <relpath-glob[:line]>  <justification...>

Every suppression carries a justification; the CLI reports unused entries.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Iterable

SEVERITIES = ("error", "warning")

# directories never scanned (fixtures are analyzed only when named explicitly)
SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "node_modules", ".venv",
             "analysis_fixtures"}


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
    """No-op defaults so a checker implements only the hook it needs."""

    id = "base"
    description = ""

    def check_file(self, path: str, tree: ast.AST, source: str) -> Iterable[Finding]:
        return ()

    def check_project(self, root: str) -> Iterable[Finding]:
        return ()


@dataclasses.dataclass
class AllowRule:
    checker: str
    pattern: str         # fnmatch over "relpath" or "relpath:line"
    reason: str
    lineno: int
    hits: int = 0

    def matches(self, f: Finding) -> bool:
        if self.checker not in ("*", f.checker):
            return False
        return fnmatch.fnmatch(f.path, self.pattern) or fnmatch.fnmatch(f.anchor, self.pattern)


class Allowlist:
    """Parsed allowlist file. Lines: ``checker glob justification...``;
    ``#`` comments and blank lines ignored; a justification is mandatory.
    ``suppressed`` collects the findings it filtered out."""

    def __init__(self, rules: list[AllowRule], path: str | None = None):
        self.rules = rules
        self.path = path
        self.suppressed: list[Finding] = []

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        rules = []
        with open(path, encoding="utf-8") as fh:
            for i, raw in enumerate(fh, 1):
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split(None, 2)
                if len(parts) < 3:
                    raise ValueError(f"{path}:{i}: allowlist entries are '<checker> <glob> "
                                     "<justification>'; a justification is required")
                rules.append(AllowRule(parts[0], parts[1], parts[2], i))
        return cls(rules, path)

    @classmethod
    def empty(cls) -> "Allowlist":
        return cls([])

    def filter(self, findings: list[Finding]) -> list[Finding]:
        """The findings no rule matches; counts each rule's hits."""
        kept = []
        for f in findings:
            rule = next((r for r in self.rules if r.matches(f)), None)
            if rule is None:
                kept.append(f)
            else:
                rule.hits += 1
                self.suppressed.append(f)
        return kept

    def unused(self) -> list[AllowRule]:
        return [r for r in self.rules if r.hits == 0]


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


def run_analysis(checkers: list, paths: list[str], root: str,
                 allowlist: Allowlist | None = None) -> list[Finding]:
    """Every file checker over ``paths``, then every project checker once;
    findings sorted by (path, line, checker), less those ``allowlist``
    suppresses. A file that fails to parse is itself a finding."""
    findings: list[Finding] = []
    file_checkers = [c for c in checkers if type(c).check_file is not BaseChecker.check_file]
    for fp in iter_python_files(paths, root):
        rel = os.path.relpath(fp, root).replace(os.sep, "/")
        try:
            with open(fp, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(Finding("parse", rel, getattr(e, "lineno", 0) or 0, str(e)))
            continue
        for c in file_checkers:
            findings.extend(c.check_file(rel, tree, source))
    for c in checkers:
        if type(c).check_project is not BaseChecker.check_project:
            findings.extend(c.check_project(root))
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return (allowlist or Allowlist.empty()).filter(findings)


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
