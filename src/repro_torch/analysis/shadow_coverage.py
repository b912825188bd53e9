"""shadow-coverage checker: every cache-bearing family rides the sanitizer
(the port's copy of ``repro/analysis/shadow_coverage.py``).

The repro-san shadow tracker (analysis/shadow.py, analysis/sanitizer.py)
protects only the families it is exercised against. Coverage is a ledger,
of the same shape as registry-coverage's capability matrix:

1. Every port registry arch with ``cache_kind`` ``kv`` or ``state`` (every
   family the scheduling core serves with a cache the sanitizer can shadow)
   appears in ``SANITIZED_ARCHS`` in ``tests/arch_matrix.py``.

2. The list does not overstate: no unknown arch ids, no ``cache_kind ==
   "none"`` families (nothing to shadow).

3. The sanitizer test module (default ``tests/test_torch_sanitizer.py``)
   exists and names ``SANITIZED_ARCHS``: the ledger is only as good as the
   test that consumes it.

A project checker: it imports the live registry, so an arch added to
``ARCH_IDS`` is audited the moment it lands.
"""

from __future__ import annotations

import os
from typing import Iterable

from repro_torch.analysis.engine import BaseChecker, Finding
from repro_torch.analysis.registry_coverage import DEFAULT_MATRIX, _matrix_lists

SANITIZED_LIST = "SANITIZED_ARCHS"
DEFAULT_TEST = "tests/test_torch_sanitizer.py"

# cache kinds the sanitizer can shadow (serving/core.py adapters)
SHADOWABLE_KINDS = ("kv", "state")


class ShadowCoverageChecker(BaseChecker):
    id = "shadow-coverage"
    description = ("every cache_kind kv/state arch appears in "
                   f"{SANITIZED_LIST} and the sanitizer test consumes it")

    def __init__(self, archs=None, build=None,
                 matrix_path: str = DEFAULT_MATRIX,
                 test_path: str = DEFAULT_TEST):
        """``archs``/``build``: injectable registry view (default: the port's
        live ``ARCH_IDS`` and ``build``) so fixtures can test the rules."""
        self._archs = archs
        self._build = build
        self.matrix_path = matrix_path
        self.test_path = test_path

    def check_project(self, root: str) -> Iterable[Finding]:
        if self._archs is None or self._build is None:
            from repro_torch.models import registry
            self._archs = self._archs or list(registry.ARCH_IDS)
            self._build = self._build or (lambda a: registry.build(registry.load_config(a)))

        mpath = os.path.join(root, self.matrix_path)
        if not os.path.isfile(mpath):
            yield Finding(self.id, self.matrix_path, 1,
                          "test matrix module missing: sanitizer coverage "
                          "has no ledger")
            return
        lists = _matrix_lists(mpath)

        kinds = {arch: getattr(self._build(arch), "cache_kind", "none")
                 for arch in self._archs}
        shadowable = {a for a, k in kinds.items() if k in SHADOWABLE_KINDS}

        if SANITIZED_LIST not in lists:
            if shadowable:
                yield Finding(
                    self.id, self.matrix_path, 1,
                    f"matrix list {SANITIZED_LIST} missing: "
                    f"{len(shadowable)} cache-bearing arch(s) have no "
                    "sanitizer coverage ledger")
            return
        lineno, ids = lists[SANITIZED_LIST]

        for arch in sorted(shadowable):
            if arch not in ids:
                yield Finding(
                    self.id, self.matrix_path, lineno,
                    f"{arch} has cache_kind={kinds[arch]!r} but no "
                    f"{SANITIZED_LIST} entry: its adapter path never runs "
                    "under REPRO_SAN — cache corruption there ships silently")
        for aid in ids:
            if aid not in kinds:
                yield Finding(
                    self.id, self.matrix_path, lineno,
                    f"{SANITIZED_LIST} names unknown arch {aid!r}")
            elif aid not in shadowable:
                yield Finding(
                    self.id, self.matrix_path, lineno,
                    f"{SANITIZED_LIST} lists {aid} but its cache_kind is "
                    f"{kinds[aid]!r} — nothing to shadow; the ledger "
                    "overstates coverage")

        tpath = os.path.join(root, self.test_path)
        if not os.path.isfile(tpath):
            yield Finding(
                self.id, self.test_path, 1,
                f"sanitizer test module missing: {SANITIZED_LIST} is a "
                "ledger nobody reads")
            return
        with open(tpath, encoding="utf-8") as fh:
            if SANITIZED_LIST not in fh.read():
                yield Finding(
                    self.id, self.test_path, 1,
                    f"{self.test_path} never references {SANITIZED_LIST}: "
                    "the sweep does not consume the ledger, so list entries "
                    "assert nothing")
