"""CLI: ``python -m repro_torch.analysis [paths...]``.

Scans the port's files by default (``src/repro_torch``, every
``tests/test_torch_*.py``, ``chip_smoke.py``). Exit codes: 0 clean, 1
findings (or unused allowlist entries with ``--strict-allowlist``), 2
usage or setup error.
"""

from __future__ import annotations

import argparse
import fnmatch
import glob
import json
import os
import sys

from repro_torch.analysis import default_checkers
from repro_torch.analysis.engine import Allowlist, run_analysis

DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")


def find_root(start: str) -> str:
    """Nearest ancestor containing pyproject.toml (else ``start``)."""
    d = os.path.abspath(start)
    while True:
        if os.path.isfile(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start)
        d = parent


def expand(paths, root: str) -> list[str]:
    """Root-relative paths, each glob expanded (sorted); a pattern that
    matches nothing is dropped."""
    out: list[str] = []
    for p in paths:
        if glob.has_magic(p):
            out += sorted(os.path.relpath(m, root)
                          for m in glob.glob(os.path.join(root, p)))
        elif os.path.exists(os.path.join(root, p)):
            out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static analysis")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to scan (default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect via pyproject.toml)")
    ap.add_argument("--allowlist", default=".repro-torch-lint-allow",
                    help="allowlist file, repo-relative (default: %(default)s)")
    ap.add_argument("--select", action="append", default=None, metavar="ID",
                    help="run only these checker ids; fnmatch globs allowed (repeatable)")
    ap.add_argument("--list", action="store_true", help="list checker ids and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON lines")
    ap.add_argument("--strict-allowlist", action="store_true",
                    help="fail on unused allowlist entries too")
    args = ap.parse_args(argv)

    checkers = default_checkers()
    if args.list:
        for c in checkers:
            print(f"{c.id:20s} {c.description}")
        return 0
    if args.select:
        known = {c.id for c in checkers}
        bad = [pat for pat in args.select if not any(fnmatch.fnmatch(k, pat) for k in known)]
        if bad:
            print(f"no checker matches {sorted(set(bad))}; known: {sorted(known)}",
                  file=sys.stderr)
            return 2
        checkers = [c for c in checkers if any(fnmatch.fnmatch(c.id, pat) for pat in args.select)]

    root = os.path.abspath(args.root) if args.root else find_root(os.getcwd())
    allow_path = os.path.join(root, args.allowlist)
    try:
        allowlist = Allowlist.load(allow_path) if os.path.isfile(allow_path) else Allowlist.empty()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2

    paths = expand(args.paths or DEFAULT_PATHS, root)
    findings = run_analysis(checkers, paths, root, allowlist)

    if args.as_json:
        for f in findings:
            print(json.dumps({"checker": f.checker, "path": f.path, "line": f.line,
                              "col": f.col, "severity": f.severity,
                              "message": f.message, "anchor": f.anchor}))
    else:
        for f in findings:
            print(f.render())

    unused = allowlist.unused()
    for rule in unused:
        print(f"{args.allowlist}:{rule.lineno}: warning[allowlist] unused entry "
              f"`{rule.checker} {rule.pattern}` — remove it or the file rots", file=sys.stderr)
    print(f"repro-lint (port): {len(findings)} finding(s), {len(allowlist.suppressed)} "
          f"suppressed by allowlist, {len(checkers)} checker(s)", file=sys.stderr)
    if findings or (args.strict_allowlist and unused):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
