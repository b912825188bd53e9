"""The launch contract for ``csrc/`` (``repro_torch.analysis.launch_contract``)
and the capture guard (``repro_torch.analysis.recompile``), on the CPU (~10 s
on one worker).

Each defect class of the launch contract is flagged on a planted ``.cu``
fixture written to ``tmp_path`` (a block of 2048 threads, an unguarded grid
y, shared memory from no helper, a helper without a mirror, a launch past
48 KB without its opt-in, a stray ``kMaxSmem``), the real ``csrc/`` is
clean, every shared-memory mirror fits ``MAX_SMEM`` at every config's
shapes, ``MAX_SMEM`` has one definition, and the card half's mirror lookup
reads real kernel names (mangled, as ``cuFuncGetName`` gives them); the
paged kernel's pools are contiguous at batch 1 and 4 (the card half found a
quantized pool at batch 1 that was not). The capture guard flags a capture
inside a loop and an unhashable program key, passes their good forms, and
is clean on the port; the CLI exits 1 on a planted ``.cu`` and capture."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import CaptureGuardChecker, default_checkers, run_analysis  # noqa: E402
from repro_torch.analysis.__main__ import DEFAULT_PATHS, expand  # noqa: E402
from repro_torch.analysis.launch_contract import (  # noqa: E402
    MIRRORS,
    LaunchContractChecker,
    card_contract,
    card_mirror,
    check_source,
    mirror_cases,
    mirror_maxima,
)
from repro_torch.analysis.program import kernel_signature  # noqa: E402
from repro_torch.kernels import cuda_build, flash_attn, gqmv, paged_attn, rmsnorm_quant  # noqa: E402
from repro_torch.serving.graphs import KernelNode  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# a launch file that keeps the contract: the helper is mirrored
# (paged_attn.combine_smem_bytes), y and z are guarded at the entry
GOOD = '''
namespace {
constexpr int kThreads = 256;
constexpr int kMaxSplits = 64;
__host__ __device__ inline size_t combine_smem_bytes(int g, int nsplit) {
  return 4 * (2 * (size_t)nsplit * g + (size_t)g);
}
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(const float* part, T* out, int g) {}

template <typename T>
int launch(const float* part, T* out, int b, int kv, int g, int nsplit, cudaStream_t s) {
  combine_kernel<T><<<dim3(kv, b, nsplit), kThreads, combine_smem_bytes(g, nsplit), s>>>(
      part, out, g);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int combine(const void* part, void* out, int b, int kv, int g, int nsplit) {
  if (b < 1 || b > 65535 || nsplit > kMaxSplits) return 1;
  return launch<float>(static_cast<const float*>(part), static_cast<float*>(out), b, kv, g,
                       nsplit, 0);
}
'''

BAD = {
    "block": ("kThreads = 256;", "kThreads = 2048;", "takes up to 2048 threads"),
    "grid": ("if (b < 1 || b > 65535 || nsplit > kMaxSplits) return 1;",
             "if (nsplit > kMaxSplits) return 1;", "grid y `b` is neither"),
    "smem": ("combine_smem_bytes(g, nsplit), s>>>", "4 * g, s>>>", "not given by a *smem_bytes"),
    "mirror": ("combine_smem_bytes", "scratch_smem_bytes", "has no Python mirror"),
    "opt_in": ("combine_smem_bytes", "mma_smem_bytes", "can pass 48 KB"),
    "max_smem": ("constexpr int kMaxSplits = 64;",
                 "constexpr int kMaxSplits = 64;\nconstexpr int kMaxSmem = 99 * 1024;",
                 "kMaxSmem = 99 * 1024"),
}


def _check(tmp_path, name: str, text: str) -> list[str]:
    path = tmp_path / name
    path.write_text(text)
    return [f.message for f in check_source(name, path.read_text())]


def test_good_fixture_is_clean(tmp_path):
    assert _check(tmp_path, "good.cu", GOOD) == []


@pytest.mark.parametrize("defect", sorted(BAD))
def test_each_defect_class_is_flagged(tmp_path, defect):
    old, new, needle = BAD[defect]
    assert old in GOOD
    found = _check(tmp_path, f"bad_{defect}.cu", GOOD.replace(old, new))
    assert len(found) == 1 and needle in found[0], found


def test_opt_in_for_the_same_kernel_passes(tmp_path):
    """The 48 KB opt-in in a helper the launch calls first, for this
    kernel, clears the finding; one for another kernel does not."""
    big = GOOD.replace("combine_smem_bytes(g, nsplit), s>>>", "mma_smem_bytes<64>(), s>>>")
    big = big.replace("template <typename T>\nint launch(", '''template <int HD>
constexpr size_t mma_smem_bytes() { return 2 * 64 * HD * 3; }
template <class K>
cudaError_t opt_in(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 99000);
}
template <typename T>
int launch(''')
    ok = big.replace("  combine_kernel<T><<<", "  opt_in(combine_kernel<T>);\n  combine_kernel<T><<<")
    assert _check(tmp_path, "opted.cu", ok) == []
    other = big.replace("  combine_kernel<T><<<", "  opt_in(other_kernel<T>);\n  combine_kernel<T><<<")
    found = _check(tmp_path, "other.cu", other)
    assert len(found) == 1 and "can pass 48 KB" in found[0]


def test_checker_clean_on_the_real_csrc():
    found = [f.render() for f in LaunchContractChecker().check_project(str(ROOT))]
    assert found == []


def test_checker_flags_a_planted_csrc_directory(tmp_path):
    (tmp_path / "good.cu").write_text(GOOD)
    (tmp_path / "bad.cu").write_text(GOOD.replace("kThreads = 256;", "kThreads = 2048;"))
    found = list(LaunchContractChecker(tmp_path).check_project(str(ROOT)))
    assert [f.path.rsplit("/", 1)[-1] for f in found] == ["bad.cu"]


@pytest.mark.parametrize("helper", sorted(MIRRORS))
def test_mirrors_fit_at_every_config_shape(helper):
    """Every mirror at every config's shapes (and every format, tile,
    head dim, pool width and block size its kernel runs at) fits the one
    opt-in."""
    cases = [(args, nbytes) for h, args, nbytes in mirror_cases() if h == helper]
    assert cases, helper
    worst = max(cases, key=lambda c: c[1])
    print(f"{helper} ({MIRRORS[helper]}): {len(cases)} shapes, most {worst[1]} bytes at "
          f"{worst[0]}")
    assert worst[1] <= cuda_build.MAX_SMEM
    assert mirror_maxima()[helper] == worst[1]


def test_max_smem_is_defined_once():
    assert gqmv.MAX_SMEM is cuda_build.MAX_SMEM is paged_attn.MAX_SMEM \
        is flash_attn.MAX_SMEM == 232448
    port = ROOT / "src" / "repro_torch"
    defs = [p.relative_to(port).as_posix() for p in port.rglob("*.py")
            if any(isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "MAX_SMEM" or isinstance(t, ast.Tuple)
                and any(getattr(e, "id", "") == "MAX_SMEM" for e in t.elts)
                for t in n.targets) for n in ast.walk(ast.parse(p.read_text())))]
    assert defs == ["kernels/cuda_build.py"]


# kernel names as cuFuncGetName gave them for the captured TinyLlama programs
SMALL = ("_ZN39_GLOBAL__N__fbb123a1_7_gqmm_cu_549ea8e117gqmm_small_kernelINS_6TcInt8ELi1ELb0EEEv"
         "PKhPKfPKaS5_Pfiiii")
PAGED = ("_ZN46_GLOBAL__N__dc93fe5f_13_paged_attn_cu_456607f817paged_attn_kernelI13__nv_bfloat16"
         "S1_Lb0ELi64EEEvPKT_PKT0_S7_PKfS9_PKiSB_S4_S4_S9_PS2_Pfiiiiiiff")
TORCH = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEESt5arrayIPcLm1EEE"
         "EviT0_T1_")


def _args(*ints, pointers: int = 0) -> tuple[bytes, ...]:
    return tuple([(0x7F0000000000 + i).to_bytes(8, "little") for i in range(pointers)]
                 + [v.to_bytes(4, "little") for v in ints])


def test_kernel_signature_reads_the_template_arguments():
    assert kernel_signature(SMALL) == ("gqmm_small_kernel", ["TcInt8", "1", "0"])
    assert kernel_signature(PAGED)[0] == "paged_attn_kernel"
    assert kernel_signature(PAGED)[1][2:] == ["0", "64"]
    assert kernel_signature("nvjet_tst_64x8_64x16_1x1_h_bz_NNT")[0].startswith("nvjet")


def test_card_mirror_of_real_kernel_nodes():
    # gqmm_small_kernel<TcInt8, 1>(wq, ws, xq, xs, out, b, m, n, gs_log2) at wo
    node = KernelNode(SMALL, (128, 1, 1), (256, 1, 1),
                      gqmv.small_smem_bytes(1, 2048, 8), _args(1, 2048, 2048, 8, pointers=5))
    assert card_mirror(node.name, node.values()) == node.smem
    assert card_contract([node], "decode") == ([], 1)
    wrong = KernelNode(SMALL, node.grid, node.block, node.smem + 16, node.args)
    bad, _ = card_contract([wrong], "decode")
    assert len(bad) == 1 and "its mirror" in bad[0]
    # paged_attn_kernel<bf16, bf16, false, 64>: kv 4, g 8, bs 8 ...
    paged = KernelNode(PAGED, (4, 1, 2), (256, 1, 1), paged_attn.smem_bytes(8, 64, 8, 2, False),
                       _args(4, 8, 8, 32, 32, 4, 0, 0, pointers=12))
    assert card_contract([paged], "paged") == ([], 1)
    # PyTorch's own kernels: held to the limits only
    fill = KernelNode(TORCH, (1, 1, 1), (128, 1, 1), 0, ())
    assert card_mirror(fill.name, []) is None and card_contract([fill], "x") == ([], 0)
    tall = KernelNode(TORCH, (1, 70000, 1), (2048, 1, 1), 0, ())
    assert len(card_contract([tall], "x")[0]) == 1
    assert rmsnorm_quant.first_smem_bytes(2048) == 8192


# ---------------------------------------------------------------------------
# capture-guard
# ---------------------------------------------------------------------------

BAD_CAPTURE = '''\
import torch


def capture_each(steps, graphs, fn, make):
    for i in range(steps):
        g = torch.cuda.CUDAGraph()  # LINT
        with torch.cuda.graph(g):  # LINT
            fn()
        graphs.program("step", (i,), fn, make)  # LINT
    while steps:
        engine.graphs.program("w", (), fn, make)  # LINT
        steps -= 1


def keyed(engine, fn, make, sizes):
    engine.graphs.program("decode", (1, [2, 3]), fn, make)  # LINT
    engine.graphs.state("decode", key={"b": 2}, make=make)  # LINT
'''

GOOD_CAPTURE = '''\
import torch


def capture_once(steps, engine, fn, make, sizes):
    prog = engine.graphs.program("step", (steps, tuple(sizes)), fn, make)
    for _ in range(steps):
        prog.replay()

    def later():
        for s in sizes:
            pass
        return torch.cuda.CUDAGraph()
    return later


def keyed(engine, fn, make, sizes):
    return engine.graphs.state("decode", (1, tuple([2, 3]), frozenset(sizes)), make)
'''


def _lint_lines(src: str) -> list[int]:
    return [i for i, line in enumerate(src.splitlines(), 1) if "# LINT" in line]


def test_capture_guard_flags_loops_and_unhashable_keys():
    found = list(CaptureGuardChecker().check_file("bad.py", ast.parse(BAD_CAPTURE), BAD_CAPTURE))
    assert sorted(f.line for f in found) == _lint_lines(BAD_CAPTURE)
    assert sum("inside a loop body" in f.message for f in found) == 4
    assert sum("unhashable" in f.message for f in found) == 2


def test_capture_guard_passes_good_forms():
    assert list(CaptureGuardChecker().check_file("good.py", ast.parse(GOOD_CAPTURE),
                                                 GOOD_CAPTURE)) == []


def test_capture_guard_clean_on_the_port():
    ids = [c.id for c in default_checkers()]
    assert "capture-guard" in ids and "launch-contract" in ids
    found = run_analysis([CaptureGuardChecker()], expand(DEFAULT_PATHS, str(ROOT)), str(ROOT))
    assert [f.render() for f in found] == []


@pytest.mark.parametrize("b", (1, 4))
@pytest.mark.parametrize("quant", (False, True), ids=("float", "int8"))
def test_paged_pools_are_contiguous(b, quant):
    """The paged kernel takes contiguous pools: a quantized pool is laid out
    anew at every batch (at b = 1 a bare reshape was a strided view, which
    the card refused); a float pool stays a view of the cache."""
    from repro_torch.models.transformer import contiguous_to_paged

    L, t, kv, hd = 2, 16, 2, 8
    if quant:
        cache = {"k_q": torch.zeros((L, b, kv, t, hd), dtype=torch.int8),
                 "k_s": torch.zeros((L, b, kv, t)),
                 "v_q": torch.zeros((L, b, kv, t, hd), dtype=torch.int8),
                 "v_s": torch.zeros((L, b, kv, t))}
    else:
        cache = {"k": torch.zeros((L, b, t, kv, hd)), "v": torch.zeros((L, b, t, kv, hd))}
    pool, table = contiguous_to_paged(cache, 8)
    assert table.shape == (b, 2)
    for name, leaf in pool.items():
        assert leaf.shape[:3] == (L, 2 * b, 8) and all(leaf[i].is_contiguous() for i in range(L))
        if not quant:
            assert leaf.data_ptr() == cache[name[0]].data_ptr()


def test_cli_exits_one_on_planted_launch_and_capture(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main as cli_main

    csrc = tmp_path / "src" / "repro_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "good.cu").write_text(GOOD)
    assert cli_main(["--root", str(tmp_path), "--select", "launch-contract"]) == 0
    (csrc / "bad.cu").write_text(GOOD.replace("kThreads = 256;", "kThreads = 2048;"))
    assert cli_main(["--root", str(tmp_path), "--select", "launch-contract"]) == 1
    bad = tmp_path / "bad_capture.py"
    bad.write_text(BAD_CAPTURE)
    assert cli_main(["--root", str(ROOT), "--select", "capture-guard", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "bad.cu" in out and "launch-contract" in out and "capture-guard" in out
