"""Rules of the port that hold by construction, checked statically:

- nothing under ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX or
  the reference package ``repro`` (the port keeps its own copies);
- the repo's own lint (``python -m repro.analysis``) has no file-level
  finding in the port's files, its tests or ``chip_smoke.py`` (the checkers'
  globs match the port's ``serving/engine.py`` and ``models/registry.py``).
"""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import default_checkers  # noqa: E402
from repro.analysis.engine import BaseChecker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree: ast.AST) -> list[str]:
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                mods.append(node.args[0].value)
    return mods


def test_port_file_list_is_complete():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/serving/engine.py",
                 "src/repro_torch/models/registry.py", "src/repro_torch/kernels/gqmv.py",
                 "src/repro_torch/kernels/paged_attn.py", "src/repro_torch/serving/core.py",
                 "src/repro_torch/serving/batching.py", "src/repro_torch/serving/paged.py",
                 "src/repro_torch/core/flags.py", "src/repro_torch/kernels/flash_attn.py",
                 "src/repro_torch/kernels/rmsnorm_quant.py",
                 "src/repro_torch/analysis/shadow.py", "src/repro_torch/analysis/sanitizer.py",
                 "src/repro_torch/analysis/adapter_lifecycle.py",
                 "src/repro_torch/analysis/registry_coverage.py",
                 "src/repro_torch/analysis/shadow_coverage.py",
                 "src/repro_torch/analysis/quant_invariants.py",
                 "src/repro_torch/analysis/__main__.py",
                 "src/repro_torch/analysis/program.py", "src/repro_torch/analysis/xray.py",
                 "src/repro_torch/analysis/launch_contract.py",
                 "src/repro_torch/analysis/recompile.py"):
        assert must in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_reference(path):
    mods = _imported_modules(ast.parse(path.read_text(), filename=str(path)))
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_lint_has_no_findings_in_port_files():
    files = PORT_FILES + sorted((ROOT / "tests").glob("test_torch_*.py")) + [
        ROOT / "tests" / "_torch_helpers.py", ROOT / "tests" / "make_torch_golden.py"]
    checkers = [c for c in default_checkers()
                if type(c).check_file is not BaseChecker.check_file]
    assert {c.id for c in checkers} >= {"host-sync", "registry-coverage"}
    findings = []
    for p in files:
        rel = p.relative_to(ROOT).as_posix()
        src = p.read_text()
        tree = ast.parse(src, filename=rel)
        for c in checkers:
            findings += [f.render() for f in c.check_file(rel, tree, src)]
    assert not findings, "\n".join(findings)


def test_registry_glob_reaches_port_registry():
    from repro.analysis.registry_coverage import RegistryCoverageChecker

    bad = "Model(cfg=cfg, init=None, supports_lengths=True)\n"
    rel = "src/repro_torch/models/registry.py"
    found = list(RegistryCoverageChecker().check_file(rel, ast.parse(bad), bad))
    assert found and "omits capability flags" in found[0].message
