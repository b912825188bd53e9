"""registry-coverage checker: capability flags vs callables vs test matrix
(the port's copy of ``repro/analysis/registry_coverage.py``, run against
``repro_torch.models.registry``).

A family gets its fast paths (ragged prefill, paged KV, speculative
decode) only through three ``Model`` flags, and a flag nobody tests is a
fast path that silently rots. Three layers of coverage:

1. **Declaration** (file check on ``models/registry.py``): every
   ``Model(...)`` construction spells out the full capability surface,
   ``supports_lengths`` / ``supports_paged`` / ``supports_spec`` plus the
   scheduling core's ``cache_kind``, even when False/"none".

2. **Consistency** (project check): for each arch, a True flag comes with
   its callables (``supports_paged`` => ``init_paged_cache`` +
   ``decode_paged``; ``supports_spec`` => ``verify``/``commit_verify``) and
   a False flag ships none of them. ``cache_kind`` is one of
   ``kv``/``state``/``none``; kv and state families ship the slot hooks
   (``insert_slots`` + ``gather_slots``, the scheduling core's contract,
   serving/core.py) and ``none`` families do not.

3. **Test matrix** (project check): each True flag appears in the matching
   list of ``tests/arch_matrix.py`` (``RAGGED_ARCHS`` / ``PAGED_ARCHS`` /
   ``SPEC_ARCHS``), read as literals with no import, and the matrix holds
   no unknown ids or capability-less entries. When an audited arch has
   ``cache_kind="state"``, ``SLOT_STATE_ARCHS`` covers the slot-state
   families the same way.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from typing import Iterable

from repro_torch.analysis.engine import BaseChecker, Finding

CAP_FLAGS = ("supports_lengths", "supports_paged", "supports_spec")

# declaration surface: the bool flags plus the scheduling-core cache kind
DECLARED = CAP_FLAGS + ("cache_kind",)

# flag -> (matrix list name, [required Model attributes when True])
CAPS = {
    "supports_lengths": ("RAGGED_ARCHS", []),
    "supports_paged": ("PAGED_ARCHS", ["init_paged_cache", "decode_paged"]),
    "supports_spec": ("SPEC_ARCHS", ["verify", "commit_verify"]),
}

CACHE_KINDS = ("kv", "state", "none")
SLOT_HOOKS = ("insert_slots", "gather_slots")
SLOT_STATE_LIST = "SLOT_STATE_ARCHS"

DEFAULT_MATRIX = "tests/arch_matrix.py"
REGISTRY_GLOB = "*models/registry.py"
REGISTRY_ANCHOR = "src/repro_torch/models/registry.py"


def _matrix_lists(path: str) -> dict[str, tuple[int, list[str]]]:
    """{LIST_NAME: (lineno, [arch ids])} for top-level list-of-str assigns."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    out: dict[str, tuple[int, list[str]]] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            continue
        elts = node.value.elts
        if not all(isinstance(e, ast.Constant) and isinstance(e.value, str)
                   for e in elts):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = (node.lineno, [e.value for e in elts])
    return out


class RegistryCoverageChecker(BaseChecker):
    id = "registry-coverage"
    description = ("every Model declares supports_lengths/paged/spec and "
                   "cache_kind explicitly; capabilities have callables, "
                   "slot hooks, and a test-matrix entry")

    def __init__(self, archs=None, matrix_path: str = DEFAULT_MATRIX,
                 build=None, registry_glob: str = REGISTRY_GLOB):
        """``archs``: arch ids to audit (default: the port's live
        ARCH_IDS); ``build``: arch_id -> Model (default: the port
        registry's ``build(load_config(arch_id))``); ``matrix_path``:
        repo-relative test-matrix module."""
        self._archs = archs
        self._build = build
        self.matrix_path = matrix_path
        self.registry_glob = registry_glob

    # -- 1. explicit declaration (static) ------------------------------------
    def check_file(self, path, tree, source) -> Iterable[Finding]:
        if not fnmatch.fnmatch(path, self.registry_glob):
            return
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "Model"):
                continue
            given = {kw.arg for kw in node.keywords if kw.arg}
            missing = [f for f in DECLARED if f not in given]
            if missing:
                yield Finding(
                    self.id, path, node.lineno,
                    f"Model(...) omits capability flags {missing}: declare "
                    "the full surface explicitly (False included) so a new "
                    "family never misses a fast path by default",
                    col=node.col_offset)

    # -- 2 + 3. live consistency and matrix coverage -------------------------
    def check_project(self, root: str) -> Iterable[Finding]:
        if self._archs is None or self._build is None:
            from repro_torch.models import registry
            self._archs = self._archs or list(registry.ARCH_IDS)
            self._build = self._build or (lambda a: registry.build(registry.load_config(a)))

        mpath = os.path.join(root, self.matrix_path)
        if not os.path.isfile(mpath):
            yield Finding(self.id, self.matrix_path, 1,
                          "test matrix module missing: capability flags have "
                          "no test coverage ledger")
            return
        lists = _matrix_lists(mpath)

        caps: dict[str, dict[str, bool]] = {}
        slot_state: dict[str, bool] = {}
        for arch in self._archs:
            model = self._build(arch)
            caps[arch] = {f: bool(getattr(model, f)) for f in CAP_FLAGS}
            for flag, (_, attrs) in CAPS.items():
                have = [a for a in attrs if getattr(model, a) is not None]
                if caps[arch][flag] and len(have) != len(attrs):
                    yield Finding(
                        self.id, REGISTRY_ANCHOR, 1,
                        f"{arch}: {flag}=True but missing callables "
                        f"{sorted(set(attrs) - set(have))}")
                elif not caps[arch][flag] and have:
                    yield Finding(
                        self.id, REGISTRY_ANCHOR, 1,
                        f"{arch}: {flag}=False yet ships {have} — dead "
                        "capability; either set the flag or drop the hooks")
            kind = getattr(model, "cache_kind", "none")
            slot_state[arch] = kind == "state"
            if kind not in CACHE_KINDS:
                yield Finding(
                    self.id, REGISTRY_ANCHOR, 1,
                    f"{arch}: cache_kind={kind!r} is not one of "
                    f"{'/'.join(CACHE_KINDS)}")
                continue
            hooks = [a for a in SLOT_HOOKS
                     if getattr(model, a, None) is not None]
            if kind in ("kv", "state") and len(hooks) != len(SLOT_HOOKS):
                yield Finding(
                    self.id, REGISTRY_ANCHOR, 1,
                    f"{arch}: cache_kind={kind!r} but missing slot hooks "
                    f"{sorted(set(SLOT_HOOKS) - set(hooks))} — the "
                    "scheduling core cannot serve this family continuously")
            elif kind == "none" and hooks:
                yield Finding(
                    self.id, REGISTRY_ANCHOR, 1,
                    f"{arch}: cache_kind='none' yet ships {hooks} — dead "
                    "capability; either declare the kind or drop the hooks")

        for flag, (list_name, _) in CAPS.items():
            if list_name not in lists:
                yield Finding(
                    self.id, self.matrix_path, 1,
                    f"matrix list {list_name} missing (needed to cover "
                    f"{flag})")
                continue
            lineno, ids = lists[list_name]
            for arch in self._archs:
                if caps[arch][flag] and arch not in ids:
                    yield Finding(
                        self.id, self.matrix_path, lineno,
                        f"{arch} has {flag}=True but no {list_name} entry: "
                        "the fast path is untested")
            for aid in ids:
                if aid not in caps:
                    yield Finding(
                        self.id, self.matrix_path, lineno,
                        f"{list_name} names unknown arch {aid!r}")
                elif not caps[aid][flag]:
                    yield Finding(
                        self.id, self.matrix_path, lineno,
                        f"{list_name} lists {aid} but its {flag} is False — "
                        "the matrix overstates coverage")

        # slot-state continuous batching: only audited when a state family
        # exists, so fixture registries without recurrent archs stay clean
        if any(slot_state.values()):
            if SLOT_STATE_LIST not in lists:
                yield Finding(
                    self.id, self.matrix_path, 1,
                    f"matrix list {SLOT_STATE_LIST} missing (needed to "
                    "cover cache_kind='state' slot-state serving)")
            else:
                lineno, ids = lists[SLOT_STATE_LIST]
                for arch, is_state in slot_state.items():
                    if is_state and arch not in ids:
                        yield Finding(
                            self.id, self.matrix_path, lineno,
                            f"{arch} has cache_kind='state' but no "
                            f"{SLOT_STATE_LIST} entry: the slot-state "
                            "continuous path is untested")
                for aid in ids:
                    if aid not in slot_state:
                        yield Finding(
                            self.id, self.matrix_path, lineno,
                            f"{SLOT_STATE_LIST} names unknown arch {aid!r}")
                    elif not slot_state[aid]:
                        yield Finding(
                            self.id, self.matrix_path, lineno,
                            f"{SLOT_STATE_LIST} lists {aid} but its "
                            "cache_kind is not 'state' — the matrix "
                            "overstates coverage")
