"""The port's static analysis (``repro_torch.analysis``): the four project
and file checkers of the serving contracts (quant-invariants,
registry-coverage, adapter-lifecycle, shadow-coverage), the engine's
project hook and allowlist, and the CLI. Each checker flags its bad cases
and passes its good ones on fixtures written to ``tmp_path`` here, and is
clean on the port's real format registry, model registry and serving code;
the CLI exits 0 on the port's tree and 1 on a bad fixture."""

import ast
import json
import types

import pytest

torch = pytest.importorskip("torch")

from pathlib import Path  # noqa: E402

from repro_torch.analysis import (  # noqa: E402
    AdapterLifecycleChecker,
    Allowlist,
    BaseChecker,
    Finding,
    HostSyncChecker,
    QuantInvariantsChecker,
    RegistryCoverageChecker,
    ShadowCoverageChecker,
    default_checkers,
    run_analysis,
)
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.core.quant import QuantFormat, get_format  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

BAD_LIFECYCLE = '''\
class LeakyAdapter:  # LINT (kind without san_state)
    kind = "leaky"

    def on_admit(self, s, r, budget):
        self.blocks[s] = self.pool.alloc(4)  # LINT

    def on_finish(self, s):
        self.blocks.pop(s)   # drops the bookkeeping, never pool.free


def serve_forever(adapter, requests):
    adapter.begin_serve()  # LINT (no end_serve)
    pending = list(requests)
    while pending:
        if not pending[0]:
            return None  # LINT (return inside the serve loop)
        pending = pending[1:]
'''

GOOD_LIFECYCLE = '''\
class PoolAdapter(CacheAdapter):
    kind = "pool"

    def on_admit(self, s, r, budget):
        self.blocks[s] = self.pool.alloc(4)

    def on_finish(self, s):
        self.pool.free(self.blocks.pop(s))

    def san_state(self):
        return {"pool": self.pool, "table": None}


class UafAdapter(PoolAdapter):
    def before_round(self, pos, live):
        self.pool.free([self.blocks[0][0]])


def serve(adapter, requests):
    adapter.begin_serve()
    pending = list(requests)
    while pending:
        if not pending[0]:
            break
        pending = pending[1:]
    adapter.end_serve()
    return pending
'''

BAD_REGISTRY = '''\
def build(cfg):
    if cfg:
        return Model(cfg=cfg, supports_lengths=True)  # LINT
    return Model(cfg=cfg, supports_lengths=False, supports_paged=False,  # LINT
                 cache_kind="none")


def fine(cfg):
    return Model(cfg=cfg, supports_lengths=False, supports_paged=False, supports_spec=False,
                 cache_kind="kv")
'''


def _lint_lines(src: str) -> list[int]:
    return [i for i, line in enumerate(src.splitlines(), 1) if "# LINT" in line]


def _write(tmp_path, name, src) -> str:
    (tmp_path / name).write_text(src)
    return name


def _fake_model(**kw):
    base = dict(supports_lengths=False, supports_paged=False, supports_spec=False,
                init_paged_cache=None, decode_paged=None, verify=None, commit_verify=None,
                cache_kind="none", insert_slots=None, gather_slots=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _fake_cfg(**kw):
    base = dict(arch_id="fake", group_size=256, d_model=256, q_dim=256, kv_dim=256, d_ff=256,
                vocab_padded=256, moe=None, mla=None, ssm=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


# ---------------------------------------------------------------------------
# quant-invariants
# ---------------------------------------------------------------------------

def _quant_msgs(fmt, configs=(), hooks=("gqmv_int8", "gqmv_int4")):
    checker = QuantInvariantsChecker(formats={fmt.name: fmt}, configs=list(configs),
                                     kernel_hooks=set(hooks))
    return [f.message for f in checker.check_project(str(ROOT))]


def test_quant_invariants_flags_inconsistent_format():
    weird = QuantFormat(name="weird", bits=4, storage_dtype=torch.int8, pack=2, qmax=8,
                        kernel="nope")
    msgs = _quant_msgs(weird)
    assert len(msgs) == 3
    assert sum("qmax 8 != 2^3-1" in m for m in msgs) == 1
    assert sum("unpack_fn" in m for m in msgs) == 1
    assert sum("kernel hook 'nope'" in m for m in msgs) == 1


def test_quant_invariants_flags_bits_pack_and_float_grid():
    short = QuantFormat(name="short", bits=3, storage_dtype=torch.int8, pack=2, qmax=3,
                        kernel="gqmv_int8", unpack_fn=lambda p: p)
    msgs = _quant_msgs(short)
    assert len(msgs) == 1 and "does not fill" in msgs[0]
    fp8 = QuantFormat(name="fp8x", bits=8, storage_dtype=torch.float8_e4m3fn, pack=1,
                      qmax=127, kernel="gqmv_int8")
    msgs = _quant_msgs(fp8)
    assert len(msgs) == 1 and "qmax 127 != 448" in msgs[0]


def test_quant_invariants_flags_non_pow2_pack():
    odd = QuantFormat(name="odd", bits=8, storage_dtype=torch.int8, pack=3, qmax=127,
                      kernel="gqmv_int8")
    msgs = _quant_msgs(odd)
    assert len(msgs) == 1 and "power of" in msgs[0]


def test_quant_invariants_flags_pack_group_straddle():
    """d_model 16 at tp 1 is quantized (GS 16), but a pack-32 format's storage
    element would straddle it, as it would each 256-wide dim's shard of 16
    at tp 16 (the production meshes' model axis); d_model 6 has no pow2
    group >= 16 and is left in float, so nothing is flagged for it."""
    wide = QuantFormat(name="int1x32", bits=1, storage_dtype=torch.int8, pack=32,
                       pack_storage=4, qmax=0, kernel="gqmv_int4", unpack_fn=lambda p: p)
    msgs = _quant_msgs(wide, [_fake_cfg(arch_id="fake-16d", d_model=16)])
    assert len(msgs) == 5 and all("straddle" in m for m in msgs)
    assert sum("d_model=16 at tp=1 " in m for m in msgs) == 1
    assert sum("at tp=16 gives shard 16" in m for m in msgs) == 4
    assert _quant_msgs(get_format("int4"), [_fake_cfg(arch_id="fake-6d", d_model=6)]) == []
    msgs = _quant_msgs(get_format("int4"), [_fake_cfg(arch_id="fake", group_size=96)])
    assert len(msgs) == 1 and "not a power of two" in msgs[0]


def test_quant_invariants_clean_on_port_registry():
    checker = QuantInvariantsChecker()
    assert list(checker.check_project(str(ROOT))) == []
    assert set(checker._formats) == {"int8", "int4", "int3", "fp8"}
    assert len(checker._configs) == 11


# ---------------------------------------------------------------------------
# registry-coverage
# ---------------------------------------------------------------------------

def test_registry_coverage_requires_explicit_flags():
    checker = RegistryCoverageChecker(registry_glob="*bad_registry.py")
    found = list(checker.check_file("x/bad_registry.py", ast.parse(BAD_REGISTRY), BAD_REGISTRY))
    assert sorted(f.line for f in found) == _lint_lines(BAD_REGISTRY)
    assert any("['supports_spec']" in f.message for f in found)
    # outside the registry glob the file is not audited
    assert list(RegistryCoverageChecker().check_file(
        "x/other.py", ast.parse(BAD_REGISTRY), BAD_REGISTRY)) == []


def test_registry_coverage_matrix_cross_check(tmp_path):
    _write(tmp_path, "matrix.py", "RAGGED_ARCHS = ['arch-a']\n"
                                  "PAGED_ARCHS = ['arch-ghost']\n"
                                  "SLOT_STATE_ARCHS = ['arch-a']\n")
    fakes = {
        "arch-a": _fake_model(supports_lengths=True, supports_paged=True,
                              init_paged_cache=lambda *a: None, decode_paged=lambda *a: None,
                              cache_kind="kv", insert_slots=len, gather_slots=len),
        "arch-b": _fake_model(decode_paged=lambda *a: None),
        "arch-s": _fake_model(cache_kind="state", insert_slots=len),
        "arch-x": _fake_model(cache_kind="blob"),
    }
    checker = RegistryCoverageChecker(archs=list(fakes), build=fakes.__getitem__,
                                      matrix_path="matrix.py")
    msgs = [f.message for f in checker.check_project(str(tmp_path))]
    assert sum("arch-b: supports_paged=False yet ships" in m for m in msgs) == 1
    assert sum("arch-a has supports_paged=True but no PAGED_ARCHS" in m for m in msgs) == 1
    assert sum("unknown arch 'arch-ghost'" in m for m in msgs) == 1
    assert sum("SPEC_ARCHS missing" in m for m in msgs) == 1
    assert sum("arch-s: cache_kind='state' but missing slot hooks" in m for m in msgs) == 1
    assert sum("arch-x: cache_kind='blob'" in m for m in msgs) == 1
    assert sum("arch-s has cache_kind='state' but no SLOT_STATE_ARCHS" in m for m in msgs) == 1
    assert sum("SLOT_STATE_ARCHS lists arch-a" in m for m in msgs) == 1
    assert len(msgs) == 8


def test_registry_coverage_clean_on_port_registry():
    checker = RegistryCoverageChecker()
    assert list(checker.check_project(str(ROOT))) == []
    assert len(checker._archs) == 11
    path = ROOT / "src" / "repro_torch" / "models" / "registry.py"
    src = path.read_text()
    rel = "src/repro_torch/models/registry.py"
    assert list(checker.check_file(rel, ast.parse(src), src)) == []


# ---------------------------------------------------------------------------
# adapter-lifecycle
# ---------------------------------------------------------------------------

def test_adapter_lifecycle_flags_leaks_and_early_returns(tmp_path):
    name = _write(tmp_path, "bad_lifecycle.py", BAD_LIFECYCLE)
    found = run_analysis([AdapterLifecycleChecker()], [name], str(tmp_path))
    assert sorted(f.line for f in found) == _lint_lines(BAD_LIFECYCLE)
    assert {f.checker for f in found} == {"adapter-lifecycle"}
    msgs = " ".join(f.message for f in found)
    for needle in ("no on_finish that frees", "san_state", "never calls end_serve",
                   "return inside"):
        assert needle in msgs


def test_adapter_lifecycle_clean_fixture(tmp_path):
    name = _write(tmp_path, "good_lifecycle.py", GOOD_LIFECYCLE)
    assert run_analysis([AdapterLifecycleChecker()], [name], str(tmp_path)) == []


def test_adapter_lifecycle_clean_on_port_serving_and_tests():
    """The port's adapters and the planted-fault adapters of its sanitizer
    tests (written as the reference's are) draw no finding."""
    paths = ["src/repro_torch/serving", "tests/test_torch_sanitizer.py",
             "tests/test_torch_sanitizer_cuda.py"]
    assert run_analysis([AdapterLifecycleChecker()], paths, str(ROOT)) == []


# ---------------------------------------------------------------------------
# shadow-coverage
# ---------------------------------------------------------------------------

def _shadow(tmp_path, fakes):
    return ShadowCoverageChecker(archs=list(fakes), build=fakes.__getitem__,
                                 matrix_path="matrix.py", test_path="test_san.py")


def test_shadow_coverage_missing_and_overstating_entries(tmp_path):
    _write(tmp_path, "matrix.py", "SANITIZED_ARCHS = ['arch-kv', 'arch-none', 'arch-ghost']\n")
    _write(tmp_path, "test_san.py", "from arch_matrix import SANITIZED_ARCHS\n")
    fakes = {"arch-kv": _fake_model(cache_kind="kv"),
             "arch-state": _fake_model(cache_kind="state"),
             "arch-none": _fake_model(cache_kind="none")}
    msgs = [f.message for f in _shadow(tmp_path, fakes).check_project(str(tmp_path))]
    assert len(msgs) == 3
    assert sum("arch-state" in m and "no SANITIZED_ARCHS entry" in m for m in msgs) == 1
    assert sum("unknown arch 'arch-ghost'" in m for m in msgs) == 1
    assert sum("arch-none" in m and "overstates" in m for m in msgs) == 1


def test_shadow_coverage_missing_list_and_consuming_test(tmp_path):
    fakes = {"arch-kv": _fake_model(cache_kind="kv")}
    _write(tmp_path, "matrix.py", "OTHER = []\n")
    msgs = [f.message for f in _shadow(tmp_path, fakes).check_project(str(tmp_path))]
    assert len(msgs) == 1 and "SANITIZED_ARCHS missing" in msgs[0]
    _write(tmp_path, "matrix.py", "SANITIZED_ARCHS = ['arch-kv']\n")
    msgs = [f.message for f in _shadow(tmp_path, fakes).check_project(str(tmp_path))]
    assert len(msgs) == 1 and "test module missing" in msgs[0]
    _write(tmp_path, "test_san.py", "def test_nothing(): pass\n")
    msgs = [f.message for f in _shadow(tmp_path, fakes).check_project(str(tmp_path))]
    assert len(msgs) == 1 and "never references" in msgs[0]


def test_shadow_coverage_clean_on_port_registry():
    checker = ShadowCoverageChecker()
    assert checker.test_path == "tests/test_torch_sanitizer.py"
    assert list(checker.check_project(str(ROOT))) == []


# ---------------------------------------------------------------------------
# engine: project hook, allowlist, parse errors
# ---------------------------------------------------------------------------

class _Project(BaseChecker):
    id = "proj"

    def check_project(self, root):
        yield Finding(self.id, "a.py", 3, "from the project hook", col=2)


def test_run_analysis_runs_project_checkers_once(tmp_path):
    _write(tmp_path, "a.py", "x = 1\n")
    _write(tmp_path, "b.py", "y = 2\n")
    found = run_analysis([_Project()], ["a.py", "b.py"], str(tmp_path))
    assert [f.render() for f in found] == ["a.py:3:2: error[proj] from the project hook"]


def test_allowlist_roundtrip_and_unused(tmp_path):
    _write(tmp_path, "allow", "# comment\nproj a.py:3 deliberate, for the test\n"
                              "proj zz/*.py never matches\n")
    allow = Allowlist.load(str(tmp_path / "allow"))
    _write(tmp_path, "a.py", "x = 1\n")
    assert run_analysis([_Project()], ["a.py"], str(tmp_path), allow) == []
    assert len(allow.suppressed) == 1
    assert [r.pattern for r in allow.unused()] == ["zz/*.py"]
    _write(tmp_path, "bad_allow", "proj a.py\n")
    with pytest.raises(ValueError, match="justification is required"):
        Allowlist.load(str(tmp_path / "bad_allow"))


def test_parse_failure_is_a_finding(tmp_path):
    _write(tmp_path, "broken.py", "def f(:\n")
    found = run_analysis([HostSyncChecker()], ["broken.py"], str(tmp_path))
    assert len(found) == 1 and found[0].checker == "parse"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_lists_the_checkers(capsys):
    assert cli_main(["--list"]) == 0
    out = capsys.readouterr().out
    ids = [c.id for c in default_checkers()]
    assert ids == ["host-sync", "quant-invariants", "registry-coverage", "adapter-lifecycle",
                   "shadow-coverage", "capture-guard", "launch-contract", "xray-donation",
                   "xray-dequant", "xray-bytes", "xray-collective"]
    for cid in ids:
        assert cid in out


def test_cli_exits_one_on_bad_fixture_and_json_carries_severity_and_col(tmp_path, capsys):
    bad = tmp_path / "bad_lifecycle.py"
    bad.write_text(BAD_LIFECYCLE)
    args = ["--root", str(ROOT), "--select", "adapter-*", str(bad)]
    assert cli_main(args) == 1
    capsys.readouterr()
    assert cli_main(args + ["--json"]) == 1
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == len(_lint_lines(BAD_LIFECYCLE))
    for row in rows:
        assert row["checker"] == "adapter-lifecycle" and row["severity"] == "error"
        assert isinstance(row["col"], int) and row["anchor"].endswith(f":{row['line']}")
    good = tmp_path / "good_lifecycle.py"
    good.write_text(GOOD_LIFECYCLE)
    assert cli_main(["--root", str(ROOT), "--select", "adapter-*", str(good)]) == 0


def test_cli_rejects_unknown_checker_id(capsys):
    assert cli_main(["--select", "no-such-*"]) == 2
    assert "no checker matches" in capsys.readouterr().err


def test_cli_clean_on_port_tree(capsys):
    """Every checker over the port's default paths (``src/repro_torch``,
    ``tests/test_torch_*.py``, ``chip_smoke.py``) and the project checks."""
    assert cli_main(["--root", str(ROOT), "--strict-allowlist"]) == 0, \
        capsys.readouterr().out
    assert "11 checker(s)" in capsys.readouterr().err
