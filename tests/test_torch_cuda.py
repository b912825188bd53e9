"""CUDA kernels of the port on the card: each kernel against its plain
version, the wrappers' argument checks, and a small end-to-end run.

Every test here needs a CUDA device and ``nvcc``; on a machine without them
they skip. This file imports neither JAX nor the reference package, so it
runs on the GPU machine as it is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: the int32 group sums of the int8, int4 and int3 kernels are
exact, so kernel and plain version differ only by the f32 order of the sum
across groups (rtol 1e-5, atol 1e-5 * max|plain|); fp8 group sums are f32
sums in another order (rtol 5e-4, atol 1e-4, the reference's tolerance for
its fp8 kernel). The paged attention kernel sums in f32 in another order
than its plain version (1e-5 * max|plain| at f32 inputs, any number of
splits); at bf16 inputs it rounds once where the plain path rounds scores
and weights to bf16 too, so it is held to the plain arithmetic in f32 on
the same values (1e-2). The flash-attention kernel is held to its plain
version the same way: 1e-5 * max|plain| at f32 (the CUDA-core kernel), and
1e-2 * max|plain| of the f32 arithmetic on the same values at bf16 and fp16
(the tensor-core kernel rounds P to the input type before P V: up to 2^-9
relative per weight in bf16). The fused
RMSNorm + quantize kernel's scales are within rtol 1e-5 of the plain
version's, and its int8 values equal them except where the plain x/S lies
within max(1e-5, 1e-6 * |x/S|) of a .5 boundary (the sum of squares is
taken in another order; see chip_smoke.RMSQ_TIE).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import flags, quant  # noqa: E402
from repro_torch.kernels import flash_attn as flash_kern  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attn as paged_kern  # noqa: E402
from repro_torch.kernels import rmsnorm_quant as rmsq_kern  # noqa: E402
from repro_torch.models.common import decode_mask  # noqa: E402
from repro_torch.models.common import rmsnorm as common_rmsnorm  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.core import Request  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.paged import PagedScheduler  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(dev, m, n, gs, b, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    wq = torch.randint(-127, 128, (m, n), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand((m, n // gs), generator=g, device=dev) + 1e-3
    xshape = (n,) if b is None else (b, n)
    xq = torch.randint(-127, 128, xshape, generator=g, device=dev, dtype=torch.int8)
    xs = torch.rand((*xshape[:-1], n // gs), generator=g, device=dev) + 1e-3
    return wq, ws, xq, xs


def _close(got, want):
    atol = 1e-5 * want.abs().max()
    assert torch.allclose(got, want, rtol=1e-5, atol=float(atol)), \
        float((got - want).abs().max())


@pytest.mark.parametrize("gs", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 13])
def test_gqmm_kernel_matches_plain(dev, gs, b):
    args = _rand(dev, 200, 1024, gs, b, seed=gs + b)
    before = kern.LAUNCHES["gqmm_int8"]
    got = kern.gqmm_cuda(*args, group_size=gs)
    assert kern.LAUNCHES["gqmm_int8"] == before + 1
    _close(got, ref.gqmm_ref(*args, group_size=gs))


@pytest.mark.parametrize("gs", [16, 32, 256])
@pytest.mark.parametrize("m,n", [(5, 256), (2560, 2048), (2048, 5632)])
def test_gqmv_kernel_matches_plain(dev, gs, m, n):
    args = _rand(dev, m, n, gs, None, seed=m)
    _close(kern.gqmv_cuda(*args, group_size=gs), ref.gqmv_ref(*args, group_size=gs))


def test_auto_dispatch_launches_kernel_on_cuda(dev):
    args = _rand(dev, 64, 256, 32, 2)
    before = kern.LAUNCHES["gqmm_int8"]
    ops.gqmm(*args, group_size=32)
    assert kern.LAUNCHES["gqmm_int8"] == before + 1
    ops.gqmm(*args, group_size=32, impl="plain")
    assert kern.LAUNCHES["gqmm_int8"] == before + 1


def test_wrappers_reject_bad_arguments(dev):
    wq, ws, xq, xs = _rand(dev, 64, 256, 32, 4)
    bad = [
        ((wq.float(), ws, xq, xs, 32), TypeError),               # dtype
        ((wq, ws.double(), xq, xs, 32), TypeError),
        ((wq, ws, xq.float(), xs, 32), TypeError),
        ((wq, ws[:, :4], xq, xs, 32), ValueError),               # shape
        ((wq, ws, xq[:, :128], xs, 32), ValueError),
        ((wq, ws, xq, xs, 48), ValueError),                      # group size
        ((wq.t(), ws, xq, xs, 32), ValueError),                  # contiguity
        ((wq, ws, xq, xs[:, ::2], 32), ValueError),
        ((wq.cpu(), ws, xq, xs, 32), ValueError),                # device
        ((wq[:, 1:-15], ws, xq, xs, 32), ValueError),
    ]
    unaligned = torch.empty(64 * 256 + 1, dtype=torch.int8, device=dev)[1:].view(64, 256)
    unaligned.copy_(wq)
    bad.append(((unaligned, ws, xq, xs, 32), ValueError))        # 16-byte alignment
    for (a, b_, c, d, gs), exc in bad:
        with pytest.raises(exc):
            kern.gqmm_cuda(a, b_, c, d, group_size=gs)
    with pytest.raises(ValueError):
        kern.gqmv_cuda(wq, ws, xq, xs, group_size=32)          # 2-D x to GQMV


def test_engine_on_cuda_matches_plain_tokens(dev):
    cfg = load_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    engine = InferenceEngine(model, model.init(seed=0, device=dev), cache_len=24,
                             quantize=True, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    kern.reset_launches()
    res = engine.generate({"tokens": toks}, 8)
    assert kern.LAUNCHES["gqmm_int8"] == (4 * cfg.num_layers + 1) * 9
    with ops.impl_scope("plain"):
        plain = engine.generate({"tokens": toks}, 8)
    assert torch.equal(res.tokens, plain.tokens)


# ---------------------------------------------------------------------------
# int4, int3 and fp8 weights (csrc/gqmm.cu)
# ---------------------------------------------------------------------------

LOWBIT = ("int4", "int3", "fp8")
PLAIN = {"int8": (ref.gqmv_ref, ref.gqmm_ref),
         "int4": (ref.gqmv_int4_ref, ref.gqmm_int4_ref),
         "int3": (ref.gqmv_int3_ref, ref.gqmm_int3_ref),
         "fp8": (ref.gqmv_fp8_ref, ref.gqmm_fp8_ref)}


def _rand_fmt(dev, fmt, m, n, gs, b, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = quant.quantize(torch.randn((m, n), generator=g, device=dev), gs, fmt)
    xshape = (n,) if b is None else (b, n)
    x = quant.quantize_activation(torch.randn(xshape, generator=g, device=dev), gs)
    return w.qvalues, w.scales, x.qvalues, x.scales


def _close_fmt(fmt, got, want):
    if fmt == "fp8":
        assert torch.allclose(got, want, rtol=5e-4, atol=1e-4), float((got - want).abs().max())
    else:
        _close(got, want)


@pytest.mark.parametrize("gs", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b", [1, 3, 4, 8, 13])
@pytest.mark.parametrize("fmt", LOWBIT)
def test_lowbit_gqmm_kernel_matches_plain(dev, fmt, gs, b):
    args = _rand_fmt(dev, fmt, 200, 1024, gs, b, seed=gs + b)
    before = kern.LAUNCHES[f"gqmm_{fmt}"]
    got = kern.gqmm_cuda(*args, group_size=gs, fmt=fmt)
    assert kern.LAUNCHES[f"gqmm_{fmt}"] == before + 1
    _close_fmt(fmt, got, PLAIN[fmt][1](*args, group_size=gs))


@pytest.mark.parametrize("gs,m,n", [(gs, m, n) for gs in (16, 32, 256) for m, n in (
    (5, 256), (2560, 2048), (2048, 5632))] + [(16, 7, 48)])
@pytest.mark.parametrize("fmt", LOWBIT)
def test_lowbit_gqmv_kernel_matches_plain(dev, fmt, gs, m, n):
    args = _rand_fmt(dev, fmt, m, n, gs, None, seed=m)
    _close_fmt(fmt, kern.gqmv_cuda(*args, group_size=gs, fmt=fmt),
               PLAIN[fmt][0](*args, group_size=gs))


def test_int3_rows_only_two_byte_aligned(dev):
    """n = 48 at GS 16: an int3 row is 18 bytes, so rows and the lanes'
    6-byte chunks are 2-byte aligned only; a layer slice of a stacked leaf
    starts mid-allocation."""
    w = quant.quantize(torch.randn((3, 9, 48), device=dev), 16, "int3")
    x = quant.quantize_activation(torch.randn((2, 48), device=dev), 16)
    for i in range(3):
        wi = w[i]
        got = kern.gqmm_cuda(wi.qvalues, wi.scales, x.qvalues, x.scales, group_size=16,
                             fmt="int3")
        _close(got, ref.gqmm_int3_ref(wi.qvalues, wi.scales, x.qvalues, x.scales,
                                      group_size=16))


# the GQMV formats that run the streamed design, and how far off a 16-byte
# boundary their first design's loads still take the storage (fp8's and
# int8's first design need 16 bytes themselves)
STREAMED = ("int3", "int4", "fp8", "int8")
FIRST_DESIGN_SHIFT = {"int3": 2, "int4": 8}


@pytest.mark.parametrize("gs", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("m,n", [(37, 2048), (13, 5632), (40, 4096), (3, 32768)])
@pytest.mark.parametrize("fmt", STREAMED)
def test_gqmv_int3_streamed_design_matches_plain(dev, fmt, gs, m, n):
    """The streamed int3, int4, fp8 and int8 GQMV at every GS: m not a
    multiple of a CTA's rows (int3 / int4: 16 at n 2048, 5 at n 5632 (3
    pieces a row), 8 at n 4096, 1 at the widest row it takes, 16 pieces; fp8
    / int8: blocks of 16 rows, fp8 staging 64 KB of f16 activations at the
    widest row, past the 48 KB opt-in); one launch a call."""
    assert kern.gqmv_design(n, fmt) == "stream"
    args = _rand_fmt(dev, fmt, m, n, gs, None, seed=m + gs)
    before = kern.LAUNCHES[f"gqmv_{fmt}"]
    got = kern.gqmv_cuda(*args, group_size=gs, fmt=fmt)
    assert kern.LAUNCHES[f"gqmv_{fmt}"] == before + 1
    _close_fmt(fmt, got, PLAIN[fmt][0](*args, group_size=gs))


@pytest.mark.parametrize("fmt", STREAMED)
def test_gqmv_int3_rows_the_streamed_design_cannot_take(dev, fmt):
    """Rows the streamed GQMV cannot take run the first design, chosen by
    pointer and shape: a stacked leaf's layer slices (int3's 18-byte rows,
    int4's 24-byte ones), storage off a 16-byte boundary (int3 2 bytes, int4
    8), n 1056 at GS 32 (no multiple of 128) and n wider than 16 pieces; and
    every row while a timing run holds the streamed width at 0."""
    plain = PLAIN[fmt][0]
    if fmt in FIRST_DESIGN_SHIFT:
        w = quant.quantize(torch.randn((3, 9, 48), device=dev), 16, fmt)
        x = quant.quantize_activation(torch.randn((48,), device=dev), 16)
        for i in range(3):
            wi = w[i]
            assert kern.gqmv_design(48, fmt, wi.qvalues.data_ptr() % 16 == 0) == "first"
            _close(kern.gqmv_cuda(wi.qvalues, wi.scales, x.qvalues, x.scales, group_size=16,
                                  fmt=fmt),
                   plain(wi.qvalues, wi.scales, x.qvalues, x.scales, group_size=16))
        shift = FIRST_DESIGN_SHIFT[fmt]
        wq, ws, xq, xs = _rand_fmt(dev, fmt, 21, 2048, 64, None, seed=2)
        off = torch.empty(wq.numel() + shift, dtype=wq.dtype, device=dev)[shift:].view(wq.shape)
        off.copy_(wq)
        assert kern.gqmv_design(2048, fmt, aligned=off.data_ptr() % 16 == 0) == "first"
        _close(kern.gqmv_cuda(off, ws, xq, xs, group_size=64, fmt=fmt),
               plain(wq, ws, xq, xs, group_size=64))
    for m, n, gs in ((30, 1056, 32), (2, 32896, 128)):
        assert kern.gqmv_design(n, fmt) == "first"
        args = _rand_fmt(dev, fmt, m, n, gs, None, seed=n)
        _close_fmt(fmt, kern.gqmv_cuda(*args, group_size=gs, fmt=fmt), plain(*args, group_size=gs))
    args = _rand_fmt(dev, fmt, 37, 2048, 64, None, seed=3)
    prev = kern.set_stream_max_n(0)
    try:
        assert kern.gqmv_design(2048, fmt, stream_max_n=0) == "first"
        _close_fmt(fmt, kern.gqmv_cuda(*args, group_size=64, fmt=fmt), plain(*args, group_size=64))
    finally:
        assert kern.set_stream_max_n(prev) == 0
    assert prev == kern.STREAM_MAX_N


def test_int4_rows_the_ring_cannot_stream(dev):
    """int4 GQMM above the cut-over on rows the large design's TMA ring cannot
    stream: layer slices of a stacked leaf (24-byte rows, slices 8-byte
    aligned only) and n = 1040 (no multiple of 128) run the first design."""
    w = quant.quantize(torch.randn((3, 9, 48), device=dev), 16, "int4")
    x = quant.quantize_activation(torch.randn((40, 48), device=dev), 16)
    for i in range(3):
        wi = w[i]
        assert kern.gqmm_design(40, 9, 48, 16, "int4", aligned=wi.qvalues.data_ptr() % 16 == 0) \
            == ("first", 0)
        got = kern.gqmm_cuda(wi.qvalues, wi.scales, x.qvalues, x.scales, group_size=16,
                             fmt="int4")
        _close(got, ref.gqmm_int4_ref(wi.qvalues, wi.scales, x.qvalues, x.scales,
                                      group_size=16))
    args = _rand_fmt(dev, "int4", 300, 1040, 16, 64, seed=4)
    assert kern.gqmm_design(64, 300, 1040, 16, "int4") == ("first", 0)
    _close(kern.gqmm_cuda(*args, group_size=16, fmt="int4"),
           ref.gqmm_int4_ref(*args, group_size=16))


# GQMM of every format (B3, B5, B6, B7): the small design at b <=
# kern.SMALL_MAX_B, the tensor-core ring above it; m not a multiple of any
# tile, b ragged
TC_BATCHES = (1, 4, 8, 9, 16, 64, 200, 256)


def _rand_tc(dev, fmt, m, n, gs, b, seed):
    return _rand(dev, m, n, gs, b, seed) if fmt == "int8" else _rand_fmt(dev, fmt, m, n, gs, b,
                                                                        seed)


def _plain_tc(fmt):
    return ref.gqmm_ref if fmt == "int8" else PLAIN[fmt][1]


@pytest.mark.parametrize("gs", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b", TC_BATCHES)
@pytest.mark.parametrize("fmt", kern.TC_FORMATS)
def test_tensor_core_gqmm_matches_plain(dev, fmt, gs, b):
    args = _rand_tc(dev, fmt, 200, 1024, gs, b, seed=gs + b)
    before = kern.LAUNCHES[f"gqmm_{fmt}"]
    got = kern.gqmm_cuda(*args, group_size=gs, fmt=fmt)
    assert kern.LAUNCHES[f"gqmm_{fmt}"] == before + 1
    _close_fmt(fmt, got, _plain_tc(fmt)(*args, group_size=gs))


@pytest.mark.parametrize("m,n,gs,b", [(4100, 2048, 256, 256), (2048, 2048, 256, 256),
                                      (300, 1040, 16, 70), (300, 1056, 32, 70),
                                      (300, 1040, 16, 5), (300, 1056, 32, 11),
                                      (2560, 2048, 256, 4), (2048, 5632, 256, 16)])
@pytest.mark.parametrize("fmt", kern.TC_FORMATS)
def test_tensor_core_gqmm_tiles_and_partial_slices(dev, fmt, m, n, gs, b):
    """The wide (128-row) and narrow tiles of the large design, a
    contraction that ends inside a 128-byte slice and a 64-column k-span
    (n = 1040 at GS 16, 1056 at GS 32), and the small design at w2's
    width."""
    args = _rand_tc(dev, fmt, m, n, gs, b, seed=m + b)
    _close_fmt(fmt, kern.gqmm_cuda(*args, group_size=gs, fmt=fmt),
               _plain_tc(fmt)(*args, group_size=gs))


@pytest.mark.parametrize("b", [1, 4, 9, 16])
@pytest.mark.parametrize("fmt", kern.TC_FORMATS)
def test_tensor_core_gqmm_designs_agree_at_one_b(dev, fmt, b):
    """Both designs at the same b (the library's cut-over moved): each
    within the tolerance of the plain version, and of each other."""
    args = _rand_tc(dev, fmt, 2048, 2048, 256, b, seed=b)
    want = _plain_tc(fmt)(*args, group_size=256)
    small = kern.gqmm_cuda(*args, group_size=256, fmt=fmt)
    prev = kern.set_small_max_b(0)
    try:
        large = kern.gqmm_cuda(*args, group_size=256, fmt=fmt)
    finally:
        kern.set_small_max_b(prev)
    assert prev == kern.SMALL_MAX_B
    _close_fmt(fmt, small, want)
    _close_fmt(fmt, large, want)


def test_lowbit_wrappers_reject_bad_arguments(dev):
    wq, ws, xq, xs = _rand_fmt(dev, "int4", 64, 256, 32, 4)
    bad = [
        ((wq.view(torch.uint8), ws, xq, xs, "int4"), TypeError),   # storage dtype
        ((wq, ws, xq, xs, "int3"), TypeError),
        ((torch.zeros(64, 256, dtype=torch.int8, device=dev), ws, xq, xs, "int4"), ValueError),
        ((wq, ws, xq, xs, "int2"), ValueError),
    ]
    for (a, b_, c, d, fmt), exc in bad:
        with pytest.raises(exc):
            kern.gqmm_cuda(a, b_, c, d, group_size=32, fmt=fmt)


@pytest.mark.parametrize("formats", ["int4", "int3", "fp8", "mixed", "mixed3"])
def test_engine_formats_on_cuda_launch_their_kernels(dev, formats):
    cfg = load_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    engine = InferenceEngine(model, model.init(seed=0, device=dev), cache_len=24,
                             quantize=formats, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    kern.reset_launches()
    res = engine.generate({"tokens": toks}, 8)
    passes = 9
    if formats in ("mixed", "mixed3"):
        packed = "int4" if formats == "mixed" else "int3"
        assert kern.LAUNCHES[f"gqmm_{packed}"] == 4 * cfg.num_layers * passes
        assert kern.LAUNCHES["gqmm_int8"] == passes                 # the classifier
    else:
        assert kern.LAUNCHES[f"gqmm_{formats}"] == (4 * cfg.num_layers + 1) * passes
    with ops.impl_scope("plain"):
        plain = engine.generate({"tokens": toks}, 8)
    assert torch.equal(res.tokens, plain.tokens)


# ---------------------------------------------------------------------------
# paged decode attention (csrc/paged_attn.cu)
# ---------------------------------------------------------------------------

def _paged(dev, pool, qdt, b=5, bs=8, mb=12, kv=4, g=8, hd=64, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = b * mb + 1
    shape = (nb, bs, kv, hd)
    if pool == "float":
        kp, vp = (torch.randn(shape, generator=gen, device=dev).to(qdt) for _ in range(2))
        ks = vs = None
    else:
        sdt = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        kp, vp = ((torch.randn(shape, generator=gen, device=dev) * 60).clamp(-127, 127)
                  .round().to(sdt) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.02 for _ in range(2))
    pos = torch.randint(0, mb * bs, (b,), generator=gen, device=dev)
    table = torch.randperm(nb - 1, generator=gen, device=dev)[: b * mb].reshape(b, mb) + 1
    table = torch.where(torch.arange(mb, device=dev)[None] > pos[:, None] // bs, 0, table)
    q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(qdt)
    kn, vn = (torch.randn((b, kv, hd), generator=gen, device=dev).to(qdt) for _ in range(2))
    mask = decode_mask(mb * bs, pos)
    return (q, kp, vp, table, pos, kn, vn, mask), dict(scale=0.125, k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
def test_paged_kernel_matches_plain_f32(dev, pool, bs, softcap):
    args, kw = _paged(dev, pool, torch.float32, bs=bs, seed=bs)
    name = "paged_attn" if pool == "float" else "paged_attn_quant"
    before = paged_kern.LAUNCHES[name]
    got = paged_kern.paged_attention_cuda(*args, softcap=softcap, **kw)
    assert paged_kern.LAUNCHES[name] == before + 1
    want = ref.paged_attention_ref(*args, softcap=softcap, **kw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
def test_paged_kernel_bf16_within_rounding_of_plain(dev, pool):
    """bf16 q and pool: the kernel works in f32 and rounds once, so it is
    within a bf16 rounding of the plain arithmetic run in f32 on the same
    values."""
    args, kw = _paged(dev, pool, torch.bfloat16, seed=7)
    got = paged_kern.paged_attention_cuda(*args, **kw)
    assert got.dtype == torch.bfloat16
    up = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    want = ref.paged_attention_ref(*up, **kw)
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
def test_paged_kernel_split_k_with_dead_splits(dev, pool, qdt):
    """One row of 2048 columns in blocks of 8 (32 tiles) at b = 1: the plan
    cuts it into 32 one-tile splits; positions near the start leave most
    splits with every block dead (table entries past pos point at the
    sink), and a position in the last tile leaves none dead. Held to the
    plain arithmetic in f32 on the same values."""
    b, bs, mb = 2, 8, 256
    assert paged_kern.split_plan(b, 4, mb, bs)[0] > 1
    args, kw = _paged(dev, pool, qdt, b=b, bs=bs, mb=mb, seed=11)
    q, kp, vp, table, pos, kn, vn, mask = args
    pos = torch.tensor([70, mb * bs - 3], device=dev)
    table = torch.where(torch.arange(mb, device=dev)[None] > pos[:, None] // bs, 0,
                        table.clamp(min=1))
    mask = decode_mask(mb * bs, pos)
    args = (q, kp, vp, table, pos, kn, vn, mask)
    got = paged_kern.paged_attention_cuda(*args, **kw)
    up = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    want = ref.paged_attention_ref(*up, **kw)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    assert (got.float() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("qdt,pool", [(torch.bfloat16, "float"), (torch.float32, "float"),
                                      (torch.bfloat16, "int8"), (torch.bfloat16, "fp8"),
                                      (torch.float32, "int8")])
@pytest.mark.parametrize("mb", [12, 256])
def test_paged_kernel_head_dim_256(dev, qdt, pool, mb):
    """gemma2's paged shape: G 2 at hd 256, blocks of 8, one split and many;
    an f32 pool runs 32-column tiles."""
    args, kw = _paged(dev, pool, qdt, b=3, bs=8, mb=mb, kv=4, g=2, hd=256, seed=mb)
    got = paged_kern.paged_attention_cuda(*args, **kw)
    up = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    want = ref.paged_attention_ref(*up, **kw)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    assert (got.float() - want).abs().max() <= tol * want.abs().max()


def test_paged_kernel_rejects_bad_arguments(dev):
    args, kw = _paged(dev, "int8", torch.float32)
    q, kp, vp, table, pos, kn, vn, mask = args
    bad = [
        ((q.double(), kp, vp, table, pos, kn, vn, mask), kw, TypeError),
        ((q, kp, vp, table, pos, kn, vn, mask), dict(kw, k_scales=None), ValueError),
        ((q, kp.float(), vp.float(), table, pos, kn, vn, mask), kw, TypeError),
        ((q, kp, vp, table.float(), pos, kn, vn, mask), kw, TypeError),
        ((q, kp, vp, table, pos, kn, vn, mask[:, :-1]), kw, ValueError),
        ((q, kp, vp, table, pos[:-1], kn, vn, mask), kw, ValueError),
        ((q.transpose(2, 3), kp, vp, table, pos, kn, vn, mask), kw, ValueError),
        ((q.cpu(), kp, vp, table, pos, kn, vn, mask), kw, ValueError),
    ]
    for a, k, exc in bad:
        with pytest.raises(exc):
            paged_kern.paged_attention_cuda(*a, **k)


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_paged_serve_on_cuda_launches_kernel_and_matches_plain(dev, kv_quant):
    cfg = load_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    engine = InferenceEngine(model, model.init(seed=0, device=dev), cache_len=32,
                             quantize=True, kv_quant=kv_quant, device=dev)
    reqs = [Request(i, list(range(1, 4 + 3 * i)), max_new=3 + i) for i in range(5)]
    sched = PagedScheduler(engine, slots=2, chunk=2)
    paged_kern.reset_launches()
    out = sched.serve(reqs, 8)
    name = "paged_attn" if kv_quant is None else "paged_attn_quant"
    assert paged_kern.LAUNCHES[name] == cfg.num_layers * sched.last_decode_steps > 0
    with ops.impl_scope("plain"):
        plain = PagedScheduler(engine, slots=2, chunk=2).serve(reqs, 8)
    for a, b in zip(out, plain):       # the reduced config is f32
        assert a.length == b.length and (a.tokens == b.tokens).all()


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attn.cu)
# ---------------------------------------------------------------------------

def _flash(dev, bh, bkv, s, t, hd, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((n, m, hd), generator=gen, device=dev).to(dtype)
            for n, m in ((bh, s), (bkv, t), (bkv, t))]


@pytest.mark.parametrize("bh,bkv,s,t,hd,causal,window,softcap", [
    (128, 16, 64, 64, 64, True, None, None),      # TinyLlama 4 x 64, GQA 32/4
    (32, 4, 200, 200, 64, True, None, None),      # a length that is no power of two
    (8, 8, 128, 128, 32, True, 32, 50.0),         # window + soft cap
    (4, 4, 64, 96, 32, False, None, None),        # non-causal, t != s
    (16, 4, 70, 70, 128, True, None, None),       # hd 128, ragged tiles
    (8, 2, 33, 33, 32, True, 5, None),
    (8, 4, 200, 200, 256, True, 48, 50.0),        # gemma2: hd 256, window + soft cap
    (8, 8, 100, 100, 112, True, None, None),      # zamba2's shared attention: hd 112
    (8, 2, 150, 150, 32, True, 48, 50.0),         # every head dim: window 48 + soft cap 50,
    (8, 2, 150, 150, 64, True, 48, 50.0),         # ragged lengths
    (8, 8, 150, 150, 112, True, 48, 50.0),
    (16, 8, 150, 150, 128, True, 48, 50.0),
    (8, 2, 130, 37, 112, False, None, None),      # non-causal, t < s (hd 112, 128, 256)
    (8, 2, 64, 150, 128, False, None, 30.0),      # non-causal, t > s, soft cap
    (8, 4, 100, 37, 256, False, None, None),
    (16, 8, 2048, 2048, 256, True, None, None),   # gemma2's 2048-token prompt
])
def test_flash_kernel_matches_plain_f32(dev, bh, bkv, s, t, hd, causal, window, softcap):
    q, k, v = _flash(dev, bh, bkv, s, t, hd, seed=s + hd)
    kw = dict(group=bh // bkv, scale=hd ** -0.5, causal=causal, window=window, softcap=softcap)
    before = flash_kern.LAUNCHES["flash_attn_f32"]
    got = flash_kern.flash_attention_cuda(q, k, v, **kw)
    assert flash_kern.LAUNCHES["flash_attn_f32"] == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("hd", flash_kern.HEAD_DIMS)
def test_flash_f32_kernel_unaligned_inputs_and_layout(dev, hd):
    """The f32 kernel on q, k, v 4 bytes off a 16-byte boundary (its 4-byte
    copies) equals its run on aligned copies; its shared memory is
    flash_attn.f32_smem_bytes and two CTAs or more fit an SM."""
    q, k, v = _flash(dev, 8, 2, 90, 90, hd, seed=hd)
    kw = dict(group=4, scale=hd ** -0.5, window=40, softcap=50.0)

    def shifted(x):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
        y.copy_(x)
        return y

    moved = [shifted(x) for x in (q, k, v)]
    assert all(x.data_ptr() % 16 for x in moved)
    got = flash_kern.flash_attention_cuda(*moved, **kw)
    assert torch.equal(got, flash_kern.flash_attention_cuda(q, k, v, **kw))
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    smem, ctas = flash_kern.f32_layout(hd, dev.index)
    assert smem == flash_kern.f32_smem_bytes(hd) and ctas >= 2


def test_flash_kernel_bf16_within_rounding_of_plain(dev):
    q, k, v = _flash(dev, 128, 16, 64, 64, 64, dtype=torch.bfloat16, seed=3)
    got = flash_kern.flash_attention_cuda(q, k, v, group=8, scale=0.125)
    assert got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), group=8, scale=0.125)
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bh,bkv,s,t,hd,causal,window,softcap", [
    (128, 16, 64, 64, 64, True, None, None),      # TinyLlama 4 x 64, GQA 32/4
    (32, 4, 2048, 2048, 64, True, None, None),    # one 2048-token prompt
    (32, 4, 200, 200, 32, True, None, None),      # s, t not multiples of 64
    (16, 4, 70, 70, 128, True, None, None),       # hd 128, ragged tiles
    (8, 8, 130, 130, 64, True, 32, 50.0),         # window + soft cap
    (8, 2, 100, 37, 64, False, None, None),       # non-causal, t < s, t not a multiple
    (4, 4, 64, 200, 128, False, None, 30.0),      # non-causal, t > s, soft cap
    (8, 2, 33, 33, 32, True, 5, None),            # a window narrower than a tile
    (8, 4, 200, 200, 256, True, 48, 50.0),        # gemma2: hd 256 (32-key tiles), window, cap
    (16, 8, 2048, 2048, 256, True, None, None),   # hd 256, a 2048-token prompt
    (8, 8, 100, 100, 112, True, None, None),      # zamba2: hd 112 (padded rows)
    (4, 4, 64, 150, 112, False, None, 30.0),      # hd 112, non-causal, t > s, soft cap
])
def test_flash_tensor_core_kernel_within_rounding_of_plain(dev, dtype, bh, bkv, s, t, hd,
                                                           causal, window, softcap):
    q, k, v = _flash(dev, bh, bkv, s, t, hd, dtype=dtype, seed=s + t + hd)
    kw = dict(group=bh // bkv, scale=hd ** -0.5, causal=causal, window=window, softcap=softcap)
    before = dict(flash_kern.LAUNCHES)
    got = flash_kern.flash_attention_cuda(q, k, v, **kw)
    assert flash_kern.LAUNCHES == {**before, "flash_attn": before["flash_attn"] + 1}
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert (got.float() - want).abs().max() <= 1e-2 * want.abs().max()


def test_flash_variant_counters_follow_the_dtype(dev):
    """bf16 and fp16 count under flash_attn (tensor cores), f32 under
    flash_attn_f32 (CUDA cores): chosen by dtype, never by a failure."""
    flash_kern.reset_launches()
    for dtype, n in ((torch.bfloat16, 2), (torch.float16, 1), (torch.float32, 3)):
        q, k, v = _flash(dev, 8, 2, 40, 40, 64, dtype=dtype)
        for _ in range(n):
            flash_kern.flash_attention_cuda(q, k, v, group=4, scale=0.125)
    assert flash_kern.LAUNCHES == {"flash_attn": 3, "flash_attn_f32": 3, "flash_attn_bwd": 0}
    assert flash_kern.kernel_name(torch.bfloat16) == "flash_attn"
    q, k, v = _flash(dev, 8, 2, 40, 40, 64, dtype=torch.bfloat16)
    shifted = torch.empty(q.numel() + 4, dtype=q.dtype, device=dev)[4:].view(q.shape)
    shifted.copy_(q)                                   # contiguous, 8 bytes off 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_kern.flash_attention_cuda(shifted, k, v, group=4, scale=0.125)


def test_flash_kernel_rejects_bad_arguments(dev):
    q, k, v = _flash(dev, 8, 2, 16, 16, 32)
    bad = [
        ((q.double(), k, v), {}, TypeError),
        ((q, k.half(), v), {}, TypeError),
        ((q.transpose(1, 2).contiguous().transpose(1, 2), k, v), {}, ValueError),
        ((q, k, v[:, :8]), {}, ValueError),
        ((q, k, v), dict(group=3), ValueError),
        ((q[..., :16].contiguous(), k[..., :16].contiguous(), v[..., :16].contiguous()), {},
         ValueError),                                     # hd 16
        ((q.cpu(), k, v), {}, ValueError),
        ((q, k, v), dict(window=0), ValueError),
    ]
    for args, extra, exc in bad:
        with pytest.raises(exc):
            flash_kern.flash_attention_cuda(*args, **{"group": 4, "scale": 0.2, **extra})


def test_blockwise_forward_on_cuda_launches_kernel_per_layer(dev):
    cfg = load_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    params = model.init(seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    with flags.overrides(blockwise_attention=True):
        flash_kern.reset_launches()
        got = model.forward(params, {"tokens": toks.to(dev)})
        # the reduced config is f32: the CUDA-core kernel, once per layer;
        # no backward without grad
        assert flash_kern.LAUNCHES == {"flash_attn": 0, "flash_attn_f32": cfg.num_layers,
                                       "flash_attn_bwd": 0}
        with ops.impl_scope("plain"):
            want = model.forward(params, {"tokens": toks.to(dev)})
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# ---------------------------------------------------------------------------
# fused RMSNorm + int8 group quantization (csrc/rmsnorm_quant.cu)
# ---------------------------------------------------------------------------

def _assert_rmsq_close(x, w, gs, got):
    qp, sp = ref.rmsnorm_quant_ref(x, w, group_size=gs)
    q, s = got
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.allclose(s, sp, rtol=1e-5, atol=0)
    diff = q.to(torch.int32) - qp.to(torch.int32)
    if diff.any():
        # only values the plain version puts at a .5 tie: within
        # max(1e-5, 1e-6 * |x/S|) of the boundary (chip_smoke.RMSQ_TIE)
        normed = common_rmsnorm(x.float(), w)
        ratio = normed.reshape(*s.shape, gs) / torch.where(sp > 0, sp, 1.0)[..., None]
        ratio = ratio.reshape(q.shape)
        near = (ratio - ratio.floor() - 0.5).abs() <= torch.clamp(1e-6 * ratio.abs(), min=1e-5)
        assert diff.abs().max() <= 1 and bool(near[diff != 0].all())


@pytest.mark.parametrize("m,n,gs", [(4, 2048, 256), (256, 2048, 256), (256, 5632, 256)]
                         + [(13, 1024, g) for g in (16, 32, 64, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_quant_kernel_matches_plain(dev, m, n, gs, dtype):
    gen = torch.Generator(device=dev).manual_seed(m + gs)
    x = (torch.randn((m, n), generator=gen, device=dev) * 3).to(dtype)
    x[0, :gs] = 0                                          # a group of zeros
    w = torch.randn((n,), generator=gen, device=dev)
    before = rmsq_kern.LAUNCHES["rmsnorm_quant"]
    got = rmsq_kern.rmsnorm_quant_cuda(x, w, group_size=gs)
    assert rmsq_kern.LAUNCHES["rmsnorm_quant"] == before + 1
    assert not got[0][0, :gs].any() and got[1][0, 0] == 0
    _assert_rmsq_close(x, w, gs, got)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16, torch.float16])
def test_rmsnorm_quant_row_design_every_dtype_pair(dev, xdt, wdt):
    """The row design at every (x, w) dtype pair, on widths that give a
    team of 1, 4 and 8 warps (with a partial last unit at n 1000 and the
    widest row, 12288), m no multiple of the rows a CTA."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for m, n, gs in ((3, 128, 16), (5, 1000, 8), (7, 2048, 256), (2, 12288, 64)):
        assert rmsq_kern.design(n, gs) == "rows"
        x = (torch.randn((m, n), generator=gen, device=dev) * 3).to(xdt)
        w = (1 + 0.1 * torch.randn((n,), generator=gen, device=dev)).to(wdt)
        _assert_rmsq_close(x, w, gs, rmsq_kern.rmsnorm_quant_cuda(x, w, group_size=gs))


def test_rmsnorm_quant_first_design_rows(dev):
    """Rows the row design cannot take run the first design, chosen by
    pointer and shape: x or w off 16 bytes, n no multiple of 8, and group
    sizes that are not a power of two from 8 to 256."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, n, gs, x_off, w_off in ((4, 2048, 256, 1, 0), (4, 2048, 256, 0, 1), (3, 100, 4, 0, 0),
                                   (3, 96, 48, 0, 0), (2, 1024, 512, 0, 0), (6, 5632, 256, 3, 0)):
        x = torch.randn((m, n), generator=gen, device=dev, dtype=torch.bfloat16) * 3
        w = torch.randn((n,), generator=gen, device=dev)
        x[0, :gs] = 0
        xb = torch.empty(x.numel() + x_off, dtype=x.dtype, device=dev)[x_off:].view(x.shape)
        wb = torch.empty(n + w_off, dtype=w.dtype, device=dev)[w_off:]
        xb.copy_(x)
        wb.copy_(w)
        aligned = xb.data_ptr() % 16 == 0 and wb.data_ptr() % 16 == 0
        assert rmsq_kern.design(n, gs, aligned) == "first"
        got = rmsq_kern.rmsnorm_quant_cuda(xb, wb, group_size=gs)
        assert not got[0][0, :gs].any() and got[1][0, 0] == 0
        _assert_rmsq_close(x, w, gs, got)


def test_rmsnorm_quant_empty_kernel_launches(dev):
    before = dict(rmsq_kern.LAUNCHES)
    for ctas in (1, rmsq_kern.plan(256, 2048)[2]):
        rmsq_kern.empty_cuda(ctas, dev)
    torch.cuda.synchronize()
    assert rmsq_kern.LAUNCHES == before
    with pytest.raises(RuntimeError):
        rmsq_kern.empty_cuda(0, dev)


def test_rmsnorm_quant_kernel_rejects_bad_arguments(dev):
    x = torch.randn((4, 256), device=dev)
    w = torch.randn((256,), device=dev)
    bad = [((x.double(), w, 64), TypeError), ((x, w[:128], 64), ValueError),
           ((x, w, 48), ValueError), ((x.t(), w, 64), ValueError),
           ((x.cpu(), w, 64), ValueError), ((x[0], w, 64), ValueError)]
    for (a, b_, gs), exc in bad:
        with pytest.raises(exc):
            rmsq_kern.rmsnorm_quant_cuda(a, b_, group_size=gs)


# ---------------------------------------------------------------------------
# captured programs (serving/graphs.py): replayed against eager, exactly
# ---------------------------------------------------------------------------

def _graph_engine(dev, kv_quant=None, quantize=True, cache_len=40):
    cfg = load_config("tinyllama-1.1b").reduced()
    model = build(cfg)
    return InferenceEngine(model, model.init(seed=3, device=dev), cache_len=cache_len,
                           quantize=quantize, kv_quant=kv_quant, device=dev)


def _all_launches():
    return {**kern.LAUNCHES, **paged_kern.LAUNCHES, **flash_kern.LAUNCHES}


def _zero_launches():
    kern.reset_launches()
    paged_kern.reset_launches()
    flash_kern.reset_launches()


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("path", ["uniform", "ragged", "paged"])
def test_graph_generate_replays_eager_tokens_and_launches(dev, path, kv_quant):
    """The captured prefill and decode step give the eager run's tokens and
    logits bit for bit, and a replayed run counts the eager run's launches."""
    from repro_torch.serving import graphs

    eng = _graph_engine(dev, kv_quant)
    toks = torch.randint(0, eng.cfg.vocab_size, (3, 12), generator=torch.Generator().manual_seed(5))
    kw = {"paged": path == "paged"}
    if path == "ragged":
        kw["lengths"] = torch.tensor([12, 7, 3])
    eng.generate({"tokens": toks}, 2, **kw)                 # build
    _zero_launches()
    got = eng.generate({"tokens": toks}, 9, **kw)
    replayed = _all_launches()
    assert eng.graphs.stats()["generate.decode"]["captured"] == 1
    _zero_launches()
    with graphs.eager():
        want = eng.generate({"tokens": toks}, 9, **kw)
    assert replayed == _all_launches() and sum(replayed.values()) > 0
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.logits_last, want.logits_last)


@pytest.mark.parametrize("mode", ["paged", "continuous", "bucketed"])
def test_graph_serve_ragged_replays_eager(dev, mode):
    from repro_torch.serving import graphs
    from repro_torch.serving.batching import serve_ragged

    eng = _graph_engine(dev)
    reqs = [Request(i, list(range(1 + i, 4 + 3 * i)), max_new=3 + i) for i in range(5)]
    got = serve_ragged(eng, reqs, 8, mode=mode, slots=2, chunk=3)
    with graphs.eager():
        want = serve_ragged(eng, reqs, 8, mode=mode, slots=2, chunk=3)
    for a, b in zip(got, want):
        assert a.length == b.length and (a.tokens == b.tokens).all()
    assert sum(s["captured"] for s in eng.graphs.stats().values()) >= 2


def test_graph_generate_under_serving_flags(dev):
    """blockwise prefill (the flash kernel), deferred decode, the kvt cache:
    replayed tokens equal eager ones, flash launched once a layer a prefill."""
    from repro_torch.serving import graphs

    eng = _graph_engine(dev)
    toks = torch.randint(0, eng.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(6))
    with flags.overrides(blockwise_attention=True, deferred_decode_cache=True,
                         kvt_cache_layout=True):
        eng.generate({"tokens": toks}, 2)
        _zero_launches()
        got = eng.generate({"tokens": toks}, 6)
        assert flash_kern.LAUNCHES["flash_attn_f32"] == eng.cfg.num_layers
        with graphs.eager():
            want = eng.generate({"tokens": toks}, 6)
    assert torch.equal(got.tokens, want.tokens)


def test_graph_capture_failure_raises(dev):
    """A host read inside a captured function fails the capture loudly;
    nothing falls back to eager execution."""
    eng = _graph_engine(dev)

    def bad(x):
        return x.sum().item()

    with pytest.raises(RuntimeError):
        eng.graphs.program("bad", (), bad, lambda: {"x": torch.ones(4, device=dev)})
    assert not [k for k in eng.graphs.programs if k[0] == "bad"]


def test_graph_capture_runs_without_garbage_collection(dev):
    """No collection runs during a capture (the warm-up before it may): a
    dropped engine's graph collected there would be reset inside the
    capture and end it."""
    import gc

    eng = _graph_engine(dev)
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x * 2

    assert gc.isenabled()
    eng.graphs.program("gc", (), fn, lambda: {"x": torch.ones(4, device=dev)})
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.parametrize("sampler", ["greedy", "top_p"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_graph_spec_generate_replays_eager(dev, paged, sampler):
    """The captured verify program (greedy, and top-p with its noise drawn
    into static buffers before each replay) gives the eager run's tokens,
    spec_stats, logits and launches; a verify step counts one pass's GQMMs
    (and, paged, the paged-attention kernel once a chunk column a layer).
    Greedy spec gives vanilla decode's tokens exactly on the card: each
    verify row sums as its decode step does."""
    from repro_torch.serving import graphs

    eng = _graph_engine(dev, cache_len=48)
    toks = torch.randint(0, eng.cfg.vocab_size, (3, 12), generator=torch.Generator().manual_seed(7))
    kw = dict(spec_k=4, paged=paged, sampler=sampler,
              sampler_kw={"p": 0.9} if sampler == "top_p" else None, seed=3)
    eng.generate({"tokens": toks}, 3, **kw)                 # build
    _zero_launches()
    got = eng.generate({"tokens": toks}, 10, **kw)
    replayed = _all_launches()
    ver = eng.graphs.last["generate.verify"]
    assert ver.graph is not None
    step = {k: n for _, k, n in ver.launches}
    assert step.get("gqmm_int8") == 4 * eng.cfg.num_layers + 1
    assert step.get("paged_attn", 0) == (4 * eng.cfg.num_layers if paged else 0)
    _zero_launches()
    with graphs.eager():
        want = eng.generate({"tokens": toks}, 10, **kw)
    assert replayed == _all_launches()
    assert torch.equal(got.tokens, want.tokens) and got.spec_stats == want.spec_stats
    assert torch.equal(got.logits_last, want.logits_last)
    if sampler == "greedy":
        van = eng.generate({"tokens": toks}, 10, paged=paged)
        assert torch.equal(got.tokens, van.tokens)
