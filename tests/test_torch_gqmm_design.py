"""The arithmetic of the tensor-core GQMM designs of ``csrc/gqmm.cu``, int8
(B3), int4 (B5), int3 (B6) and fp8 (B7), emulated in plain PyTorch on the
CPU and held against the reference package (the CUDA kernels run in
tests/test_torch_cuda.py on the card).

- Large design (b above the cut-over): tiles of weight rows x 64 batch rows
  (ragged edges zero-filled), int32 sums of 32-column k-steps (16 at GS 16)
  added into each group's sum, each group's sum scaled as the plain version
  scales it (int8 ``(s * ws) * xs``, int4 / int3 / fp8 ``(s * xs) * ws``,
  each product rounded in f32) and added in f32 into an even-group or
  odd-group sum, each left to right; the output is even + odd. fp8: f32
  sums of 16-column k-steps (e4m3 weights and int8 activations in f16, whose
  products are exact in f32), added in f32 into the group's sum.
- Small design (b at or below the cut-over): units of whole groups (a group
  of GS >= 64, else a 64-column k-span), one per warp per round of 8; each
  round's terms added in group order into the even and odd sums, as above.
  fp8's k16-steps there take, of each 64-column k-span, the columns 16t +
  4i .. 16t + 4i + 3 (t = 0..3) as mma i.

The one order of both designs is the first design's at GS 256 (the even groups summed
on one lane, the odd ones on another, then added): with it the 2-layer
int8 golden stays token-exact on the card.

Both are held to the reference's oracles (``gqmm_ref``, ``gqmm_int4_ref``,
``gqmm_int3_ref``, ``gqmm_fp8_ref``) and its Pallas kernels in interpret
mode on numpy-made inputs: the int32 group sums must be equal, the outputs
within 1e-5 of max|ref| (another f32 order of the sum across groups); fp8
within rtol 5e-4 and atol 1e-4 (``chip_smoke.FP8_TOL``, the reference's own
for its fp8 kernel: the group sums are f32 sums in another order). Then the
constants of ``kernels/gqmv.py`` against ``csrc/gqmm.cu``, and the paged
kernel's head dims against the reference's paged configs.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gqmv import (gqmm_fp8_pallas, gqmm_int3_pallas,  # noqa: E402
                                gqmm_int4_pallas, gqmm_pallas)
from repro.models.registry import ARCH_IDS, build as jbuild, load_config as jload  # noqa: E402
from repro_torch.core.quant import unpack_int3, unpack_int4  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels import paged_attn as paged_kern  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

CSRC = Path(kern.__file__).resolve().parents[1] / "csrc"
GROUP_SIZES = (16, 32, 64, 128, 256)
INT_FORMATS = tuple(f for f in kern.TC_FORMATS if f != "fp8")   # exact int32 group sums
FP8_TOL = (5e-4, 1e-4)      # chip_smoke.FP8_TOL: rtol, atol
ORACLES = {"int8": (jref.gqmm_ref, gqmm_pallas, ref.gqmm_ref),
           "int4": (jref.gqmm_int4_ref, gqmm_int4_pallas, ref.gqmm_int4_ref),
           "int3": (jref.gqmm_int3_ref, gqmm_int3_pallas, ref.gqmm_int3_ref),
           "fp8": (jref.gqmm_fp8_ref, gqmm_fp8_pallas, ref.gqmm_fp8_ref)}


def _inputs(fmt, m, n, gs, b, seed):
    """numpy-made (wq storage, ws, xq, xs) and the weight values (int8, or
    f32 for fp8)."""
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (b, n), dtype=np.int8)
    xs = (rng.random((b, n // gs), dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    if fmt == "int8":
        wq = rng.integers(-127, 128, (m, n), dtype=np.int8)
        ws = (rng.random((m, n // gs), dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
        return wq, ws, xq, xs, wq
    quantize = {"int4": jquant.quantize_int4, "int3": jquant.quantize_int3,
                "fp8": jquant.quantize_fp8}[fmt]
    w = quantize(jnp.asarray(rng.standard_normal((m, n), dtype=np.float32)), gs)
    wq, ws = np.array(w.qvalues), np.array(w.scales)
    if fmt == "fp8":
        return wq, ws, xq, xs, wq.astype(np.float32)
    unpack = unpack_int4 if fmt == "int4" else unpack_int3
    return wq, ws, xq, xs, unpack(torch.from_numpy(wq.copy())).numpy()


def _torch(a):
    """A numpy input as a torch tensor (e4m3 through its bytes)."""
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _term(sums, ws, xs, fmt):
    """(b, m, ng) f32 scaled terms, each product rounded in f32."""
    s = sums.to(torch.float32)
    if fmt == "int8":
        return (s * ws[None]) * xs[:, None, :]
    return (s * xs[:, None, :]) * ws[None]


def _step_sums(wv, xq, gs):
    """(b, m, ng) int64 group sums built from the k-steps the mma runs:
    32 columns (16 at GS 16), each an exact integer dot."""
    m, n = wv.shape
    b = xq.shape[0]
    step = min(gs, 32)
    w = torch.from_numpy(wv.astype(np.int64)).reshape(m, n // step, step)
    x = torch.from_numpy(xq.astype(np.int64)).reshape(b, n // step, step)
    steps = torch.einsum("mks,bks->bmk", w, x)
    return steps.reshape(b, m, n // gs, gs // step).sum(-1)


def _fp8_step_sums(wv, xq, gs, small=False):
    """(b, m, ng) f32 group sums of fp8 built from the k16-steps the mma
    runs: each step's products (exact in f32) summed in f32, the steps added
    in f32 in order. Large design: 16 contiguous columns a step. Small
    design: each 64-column k-span's mmas i = 0..3 in order, mma i taking
    columns 16t + 4i + c of lanes t = 0..3; at GS 16 and 32 a group holds
    one or two lanes t (the others' weights are zeroed), so its step i sums
    4 or 8 columns."""
    m, n = wv.shape
    b = xq.shape[0]
    ng = n // gs
    prod = torch.from_numpy(xq.astype(np.float32))[:, None, :] * torch.from_numpy(wv)[None]
    if small:
        assert n % kern.SPAN == 0
        lanes = min(gs, kern.SPAN) // 16             # lanes t whose columns a group holds
        p = prod.reshape(b, m, n // kern.SPAN, 4, 4, 4).sum(-1)      # (span, t, mma i)
        steps = p.reshape(b, m, n // kern.SPAN, 4 // lanes, lanes, 4).sum(4)
    else:
        steps = prod.reshape(b, m, ng, gs // 16, 16).sum(-1)
    steps = steps.reshape(b, m, ng, -1)
    acc = torch.zeros((b, m, ng))
    for k in range(steps.shape[-1]):
        acc = acc + steps[..., k]
    return acc


def _group_sums(wv, xq, gs, fmt, small=False):
    return _fp8_step_sums(wv, xq, gs, small) if fmt == "fp8" else _step_sums(wv, xq, gs)


def emulate_large(wv, ws, xq, xs, gs, fmt, rows=kern.WIDE_ROWS):
    """The large design: tiles of ``rows`` weight rows x LARGE_COLS batch
    rows, zero-padded at the ragged edges; groups added left to right."""
    m, n = wv.shape
    b = xq.shape[0]
    mp, bp = -(-m // rows) * rows, -(-b // kern.LARGE_COLS) * kern.LARGE_COLS
    wpad = np.zeros((mp, n), wv.dtype)
    wpad[:m] = wv
    xpad = np.zeros((bp, n), np.int8)
    xpad[:b] = xq
    wsp = torch.zeros((mp, n // gs))
    wsp[:m] = torch.from_numpy(ws)
    xsp = torch.zeros((bp, n // gs))
    xsp[:b] = torch.from_numpy(xs)
    out = torch.zeros((bp, mp))
    for m0 in range(0, mp, rows):
        for b0 in range(0, bp, kern.LARGE_COLS):
            wt, xt = wpad[m0:m0 + rows], xpad[b0:b0 + kern.LARGE_COLS]
            terms = _term(_group_sums(wt, xt, gs, fmt), wsp[m0:m0 + rows],
                          xsp[b0:b0 + kern.LARGE_COLS], fmt)
            out[b0:b0 + kern.LARGE_COLS, m0:m0 + rows] = _even_odd(terms, range(terms.shape[-1]))
    return out[:b, :m]


def _even_odd(terms, groups):
    """even + odd: the terms of ``groups`` (in the order given) added into
    the sum of their parity, each starting from 0."""
    sums = [torch.zeros(terms.shape[:2]), torch.zeros(terms.shape[:2])]
    for g in groups:
        sums[g % 2] = sums[g % 2] + terms[..., g]
    return sums[0] + sums[1]


def small_rounds(n, gs):
    """The small design's rounds: for each, every warp's unit as the list of
    its groups (a warp past the last unit has none)."""
    width = max(gs, kern.SPAN)
    per_unit, ng = width // gs if gs < kern.SPAN else 1, n // gs
    nunits = -(-n // width)
    rounds = []
    for r in range(-(-nunits // kern.SMALL_WARPS)):
        units = [r * kern.SMALL_WARPS + w for w in range(kern.SMALL_WARPS)]
        rounds.append([[g for g in range(u * per_unit, (u + 1) * per_unit) if g < ng]
                       if u < nunits else [] for u in units])
    return rounds


def emulate_small(wv, ws, xq, xs, gs, fmt):
    """The small design: each round's terms, warp by warp and group by
    group, into the even and odd sums."""
    terms = _term(_group_sums(wv, xq, gs, fmt, small=True), torch.from_numpy(ws),
                  torch.from_numpy(xs), fmt)
    order = [g for rnd in small_rounds(wv.shape[1], gs) for unit in rnd for g in unit]
    return _even_odd(terms, order)


def _oracles(fmt, wq, ws, xq, xs, gs):
    oracle, pallas, _ = ORACLES[fmt]
    args = tuple(jnp.asarray(a) for a in (wq, ws, xq, xs))
    return (np.asarray(oracle(*args, group_size=gs)),
            np.asarray(pallas(*args, group_size=gs, interpret=True)))


def _within(got, want, fmt="int8"):
    if fmt == "fp8":
        assert (np.abs(got - want) <= FP8_TOL[0] * np.abs(want) + FP8_TOL[1]).all()
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# (m, n, b): m no multiple of a tile; b on both sides of the cut-over
SHAPES = [(200, 1024, 3), (200, 1024, 16), (200, 1024, 17), (70, 512, 70)]


@pytest.mark.parametrize("gs", GROUP_SIZES)
@pytest.mark.parametrize("m,n,b", SHAPES)
@pytest.mark.parametrize("fmt", kern.TC_FORMATS)
def test_tensor_core_designs_match_reference(fmt, gs, m, n, b):
    wq, ws, xq, xs, wv = _inputs(fmt, m, n, gs, b, seed=gs * 7 + b)
    want, pallas = _oracles(fmt, wq, ws, xq, xs, gs)
    plain = ORACLES[fmt][2](*(_torch(a) for a in (wq, ws, xq, xs)), group_size=gs).numpy()
    for rows in (kern.WIDE_ROWS, kern.NARROW_ROWS):
        large = emulate_large(wv, ws, xq, xs, gs, fmt, rows).numpy()
        _within(large, want, fmt)
        _within(large, pallas, fmt)
    small = emulate_small(wv, ws, xq, xs, gs, fmt).numpy()
    _within(small, want, fmt)
    _within(small, pallas, fmt)
    _within(plain, want, fmt)


# the families' rows with an odd number of groups at GS 256 (gemma2-2b's
# d 2304: 9; deepseek-coder-33b's d_ff 19200: 75), a few rows each, b on
# both sides of the cut-over: the even/odd order of the group terms with
# one more even term than odd
ODD_GROUP_SHAPES = [(24, 2304, 4), (24, 2304, 17), (8, 19200, 3), (8, 19200, 17)]


@pytest.mark.parametrize("m,n,b", ODD_GROUP_SHAPES)
@pytest.mark.parametrize("fmt", kern.TC_FORMATS)
def test_tensor_core_designs_match_reference_at_odd_group_counts(fmt, m, n, b):
    gs = 256
    wq, ws, xq, xs, wv = _inputs(fmt, m, n, gs, b, seed=n + b)
    want = _oracles(fmt, wq, ws, xq, xs, gs)[0]
    for rows in (kern.WIDE_ROWS, kern.NARROW_ROWS):
        _within(emulate_large(wv, ws, xq, xs, gs, fmt, rows).numpy(), want, fmt)
    _within(emulate_small(wv, ws, xq, xs, gs, fmt).numpy(), want, fmt)


@pytest.mark.parametrize("b", range(1, 18))
def test_small_design_cut_over_at_deepseek_w2(b):
    """deepseek-coder-33b's w2 (n 19200, 75 groups): up to 8 activation rows
    fit the small design's shared memory (one 8-row tile, ~177 KB), 9-16
    would need two tiles (~351 KB, past the opt-in), so they run the large
    design."""
    tiles8 = 1 if b <= 8 else 2
    fits = kern.small_smem_bytes(tiles8, 19200, 75) <= kern.MAX_SMEM
    assert fits == (b <= 8)
    assert kern.gqmm_design(b, 7168, 19200, 256)[0] == ("small" if b <= 8 else "large")


@pytest.mark.parametrize("gs", GROUP_SIZES)
@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_k_step_group_sums_equal_the_reference(fmt, gs):
    """The int32 sums the mmas build (32-column k-steps, 16 at GS 16) are the
    reference's group sums exactly."""
    m, n, b = 40, 512, 9
    wq, ws, xq, xs, wv = _inputs(fmt, m, n, gs, b, seed=gs)
    ng = n // gs
    want = np.einsum("mgk,bgk->bmg", wv.reshape(m, ng, gs).astype(np.int32),
                     xq.reshape(b, ng, gs).astype(np.int32))
    assert np.array_equal(_step_sums(wv, xq, gs).numpy(), want)


@pytest.mark.parametrize("n,gs", [(2048, 256), (5632, 256), (1024, 16), (1056, 32)])
@pytest.mark.parametrize("fmt", INT_FORMATS)
def test_designs_agree_bitwise_and_keep_each_scaled_term(fmt, n, gs):
    """Both designs add the groups in one order (even groups, odd groups,
    each left to right): equal bits, at any b. Each term is the plain
    version's product, rounded twice in f32 in its association."""
    wq, ws, xq, xs, wv = _inputs(fmt, 64, n, gs, 5, seed=1)
    assert torch.equal(emulate_small(wv, ws, xq, xs, gs, fmt),
                       emulate_large(wv, ws, xq, xs, gs, fmt))
    wq, ws, xq, xs, wv = _inputs(fmt, 64, 2048, 256, 5, seed=1)
    sums = _step_sums(wv, xq, 256)
    t = _term(sums, torch.from_numpy(ws), torch.from_numpy(xs), fmt)
    s32 = sums.numpy().astype(np.float32)
    if fmt == "int8":
        want = (s32 * ws[None]) * xs[:, None, :]
    else:
        want = (s32 * xs[:, None, :]) * ws[None]
    assert np.array_equal(t.numpy(), want)


@pytest.mark.parametrize("n,gs", [(2048, 256), (5632, 256), (1024, 16), (1056, 32), (48, 16),
                                  (256, 256), (1024, 128)])
def test_small_design_rounds_cover_every_group_once_in_order(n, gs):
    rounds = small_rounds(n, gs)
    order = [g for rnd in rounds for unit in rnd for g in unit]
    assert order == list(range(n // gs))
    for rnd in rounds:
        assert len(rnd) == kern.SMALL_WARPS
        for unit in rnd:
            # a unit is whole groups in whole k-spans, at most UNROLL spans
            # of loads and UNIT_GROUPS groups
            assert len(unit) <= kern.UNIT_GROUPS
            assert not unit or unit[0] * gs % kern.SPAN == 0
            assert len(unit) * gs <= kern.UNROLL * kern.SPAN


def _cuda_constants() -> dict[str, int]:
    src = (CSRC / "gqmm.cu").read_text()
    return {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_design_constants_mirror_the_cuda_source():
    c = _cuda_constants()
    assert c["kSmallMaxB"] == kern.SMALL_MAX_B
    assert c["kSmallRows"] == kern.SMALL_ROWS and c["kSmallWarps"] == kern.SMALL_WARPS
    assert c["kSpan"] == kern.SPAN and c["kUnroll"] == kern.UNROLL
    assert c["kUnitGroups"] == kern.UNIT_GROUPS
    assert c["kLargeCols"] == kern.LARGE_COLS and c["kBK"] == kern.BK
    assert c["kStagesTc"] == kern.STAGES and c["kSms"] == kern.SMS
    assert c["kStageGroups"] == kern.STAGE_GROUPS == kern.BK // 16
    assert c["kScaleStride"] == kern.SCALE_STRIDE
    assert c["kSwizzleAlign"] == kern.SWIZZLE_ALIGN
    assert c["kMaxSmem"] == kern.MAX_SMEM
    assert c["kStagesF16"] == kern.FP8_STAGES
    src = (CSRC / "gqmm.cu").read_text()
    assert "constexpr int kXAtomBytes = kLargeCols * 128;" in src
    assert kern.X_ATOM_BYTES == kern.LARGE_COLS * 128
    # the bytes a weight row takes in a stage, as stored, per format's ring
    rings = dict(re.findall(
        r"struct TcRing<Tc(\w+)> \{\n  static constexpr int kSliceBytes = ([^;]+);", src))
    assert {k: eval(v, {"kBK": kern.BK}) for k, v in rings.items()} == {
        "Int8": kern.SLICE_BYTES["int8"], "Int3": kern.SLICE_BYTES["int3"],
        "Int4": kern.SLICE_BYTES["int4"]}
    assert "struct TcRing<TcFp8> : TcRing<TcInt8> {};" in src
    assert kern.SLICE_BYTES["fp8"] == kern.SLICE_BYTES["int8"] == kern.BK
    # every format's GQMM runs the two tensor-core designs
    for fmt, loader in (("int8", "TcInt8, false"), ("int4", "TcInt4, true"),
                        ("int3", "TcInt3, true"), ("fp8", "TcFp8, true")):
        assert f"GQMM_ENTRY_POINT({fmt}, (run_gqmm_tc<{loader}>))" in src
    # the large design's two tile widths: 32 rows a warp, 2 (narrow) or 4
    # (wide) warps along the rows
    assert "GQMM_LARGE(4, true)" in src and "GQMM_LARGE(2, true)" in src
    assert (32 * 4, 32 * 2) == (kern.WIDE_ROWS, kern.NARROW_ROWS)


@pytest.mark.parametrize("b,m,want", [(1, 2048, ("small", 1)), (4, 32000, ("small", 1)),
                                      (8, 2560, ("small", 1)), (9, 2048, ("small", 2)),
                                      (16, 11264, ("small", 2)), (17, 2048, ("large", 64)),
                                      (64, 2048, ("large", 64)), (256, 2048, ("large", 64)),
                                      (256, 2560, ("large", 64)), (256, 11264, ("large", 128)),
                                      (256, 32000, ("large", 128))])
def test_design_choice_by_b(b, m, want):
    """At TinyLlama's shapes: decode and the ragged serve's b <= 8 run the
    small design; the 4 x 64 prefill's b = 256 the large one, with 64-row
    tiles where 128-row ones would leave SMs idle (wo, wqkv, w2)."""
    assert kern.gqmm_design(b, m, 2048, 256) == want


def test_small_smem_bytes_mirror_the_layout():
    """Activation rows at a stride 64 bytes past a multiple of 128 (so the
    8 rows of a B-fragment load fall in distinct bank groups), their
    scales, the CTA's 16 rows of weight scales, one round's scaled terms
    (8 warps x 4 groups x 16 rows x the batch rows)."""
    for n, gs, t8 in ((2048, 256, 1), (5632, 256, 2), (1040, 16, 2)):
        stride = kern.small_x_stride(n)
        assert stride % 128 == 64 and stride >= n
        ng = n // gs
        assert kern.small_smem_bytes(t8, n, ng) == (8 * t8 * stride + 4 * 8 * t8 * ng
                                                    + 4 * 16 * ng + 4 * 8 * 4 * 16 * 8 * t8)
    assert kern.small_smem_bytes(2, 5632, 5632 // 256) <= kern.MAX_SMEM


@pytest.mark.parametrize("fmt", kern.TC_FORMATS)
def test_large_smem_bytes_fit_the_opt_in(fmt):
    """Five stages, four for fp8 (the weight slice, int4 packed at 64 bytes
    a row, int3 at 48; the activation slice; both scales; each padded to
    1 KB, where a 128-byte-swizzled TMA tile must start), int4's and int3's
    unpacked tile, fp8's f16 activation tile (64 rows x 256 bytes) and an
    mbarrier a stage, with 1 KB of room to align the base, fit the 227 KB a
    CTA can opt into; two 64-row CTAs fit an SM."""
    assert 2 * kern.large_smem_bytes(fmt, kern.NARROW_ROWS) <= 228 * 1024
    stages = 4 if fmt == "fp8" else 5
    for rows in (kern.NARROW_ROWS, kern.WIDE_ROWS):
        w_tile = rows * {"int8": 128, "int4": 64, "int3": 48, "fp8": 128}[fmt]
        stage = -(-(w_tile + 64 * 128 + 4 * (rows + 64) * 9) // 1024) * 1024
        want = (1024 + stages * stage + (rows * 128 if fmt in ("int4", "int3") else 0)
                + (64 * 256 if fmt == "fp8" else 0) + 8 * stages)
        assert kern.large_smem_bytes(fmt, rows) == want <= kern.MAX_SMEM
        assert w_tile % 1024 == 0              # the activation tile starts swizzle-aligned


def test_int4_rows_the_ring_cannot_stream_run_the_first_design():
    """int4 rows are n / 2 bytes: a layer slice of a stacked leaf may be only
    8-byte aligned, and n no multiple of 128 leaves a partial 64-byte slice;
    above the cut-over both run the first design. int8 and fp8 rows always
    stream (the wrapper requires 16-byte rows)."""
    assert kern.gqmm_design(64, 300, 1040, 16, "int4") == ("first", 0)
    assert kern.gqmm_design(64, 300, 1024, 16, "int4", aligned=False) == ("first", 0)
    assert kern.gqmm_design(64, 300, 1024, 16, "int4") == ("large", 64)
    assert kern.gqmm_design(256, 32000, 2048, 256, "int4") == ("large", 128)
    assert kern.gqmm_design(16, 300, 1040, 16, "int4", aligned=False) == ("small", 2)
    assert kern.gqmm_design(64, 300, 1040, 16, "fp8") == ("large", 64)


def test_int3_rows_the_ring_cannot_stream_run_the_first_design():
    assert kern.gqmm_design(64, 300, 1040, 16, "int3") == ("first", 0)
    assert kern.gqmm_design(64, 300, 1024, 16, "int3", aligned=False) == ("first", 0)
    assert kern.gqmm_design(64, 300, 1024, 16, "int3") == ("large", 64)
    assert kern.gqmm_design(64, 300, 1040, 16, "int8") == ("large", 64)
    assert kern.gqmm_design(4, 300, 1040, 16, "int3", aligned=False) == ("small", 1)


def test_paged_head_dims_cover_the_reference_paged_configs():
    """Every head dim of a reference config whose model has a paged path
    (gemma2-2b's 256 among them) is one the port's paged kernel takes, with
    its G * hd within the kernel's outputs a CTA."""
    seen = set()
    for arch in ARCH_IDS:
        cfg = jload(arch)
        if cfg.model_type != "decoder_lm" or not jbuild(cfg).supports_paged:
            continue
        hd, g = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
        seen.add(hd)
        assert hd in paged_kern.HEAD_DIMS, arch
        assert g * hd <= paged_kern.MAX_OUT * paged_kern.THREADS, arch
    assert 256 in seen


@pytest.mark.parametrize("hd,elt,cols", [(256, 4, 32), (256, 2, 64), (256, 1, 64),
                                         (128, 4, 64), (64, 2, 64)])
def test_paged_tile_width_fits_shared_memory(hd, elt, cols):
    """Only an f32 pool at hd 256 runs 32-column tiles; at G 2 and blocks of
    8 every pool type at hd 256 fits the 227 KB a CTA can opt into."""
    assert paged_kern.tile_cols(hd, elt) == cols
    quant = elt == 1
    assert paged_kern.smem_bytes(2, hd, 8, elt, quant) <= paged_kern.MAX_SMEM
    tb = paged_kern.tile_blocks(8, cols)
    tc = tb * 8
    regions = [3 * 2 * tc * hd * elt, (3 * 2 * tc * 4) if quant else 0, 4 * 2 * hd, 4 * 2 * hd,
               4 * 2 * tc, 4 * 3 * 2, 4 * 5 * tc, 4 * 5 * tb, 4 * 3 * tc]
    assert paged_kern.smem_bytes(2, hd, 8, elt, quant) == sum(regions)


def test_fp8_and_int8_values_are_exact_in_f16():
    """fp8's tensor-core designs feed e4m3 weights and int8 activations to
    f16 mmas with f32 sums: every finite e4m3 value and every int8 value is
    an f16 value, the kernel's int8 -> f16 conversion (the byte biased by
    128 as the mantissa of 1024 + 128 + x, minus 1152) is exact, and every
    product of the two is exact in f32."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn)
    e4m3 = codes.to(torch.float32)
    e4m3 = e4m3[torch.isfinite(e4m3)]
    assert e4m3.numel() == 254
    assert torch.equal(e4m3.to(torch.float16).to(torch.float32), e4m3)
    x = np.arange(-128, 128, dtype=np.int32)
    biased = (0x6400 | ((x ^ 0x80) & 0xFF)).astype(np.uint16).view(np.float16)
    assert np.array_equal((biased - np.float16(1152)).astype(np.int32), x)
    assert np.array_equal(x.astype(np.float16).astype(np.int32), x)
    prod32 = e4m3[:, None] * torch.from_numpy(x.astype(np.float32))[None]
    prod64 = e4m3.double()[:, None] * torch.from_numpy(x.astype(np.float64))[None]
    assert torch.equal(prod32.double(), prod64)


@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_fp8_k16_group_sums_within_f32_rounding(gs):
    """The f32 group sums of fp8's k16-steps, in either design's order, are
    the exact group sums to within the f32 rounding of their additions
    (GS / 16 + 16 terms' worth of 2^-24 of the largest partial sum)."""
    m, n, b = 40, 512, 9
    wq, ws, xq, xs, wv = _inputs("fp8", m, n, gs, b, seed=gs + 3)
    exact = np.einsum("mgk,bgk->bmg", wv.reshape(m, n // gs, gs).astype(np.float64),
                      xq.reshape(b, n // gs, gs).astype(np.float64))
    absum = np.einsum("mgk,bgk->bmg", np.abs(wv.reshape(m, n // gs, gs)).astype(np.float64),
                      np.abs(xq.reshape(b, n // gs, gs)).astype(np.float64))
    for small in (False, True):
        got = _fp8_step_sums(wv, xq, gs, small).double().numpy()
        assert (np.abs(got - exact) <= (gs + 16) * 2.0 ** -24 * absum).all()
