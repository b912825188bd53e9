"""The streamed GQMV design for int4, fp8 and int8 weights (``csrc/gqmm.cu``:
``gqmv_stream_kernel`` with ``StreamInt4``, ``gqmv_stream_block_kernel``
with ``StreamFp8`` and ``StreamInt8``): its partition and order of f32 sums
emulated in numpy on the CPU and held against the reference package's
oracles ``gqmv_int4_ref``, ``gqmv_fp8_ref`` and ``gqmv_ref`` (int8 also
against ``gqmv_pallas`` in interpret mode), and int4's 64-byte chunk
unpacking against the port's ``unpack_int4`` (the kernels themselves run in
tests/test_torch_cuda.py on the card; int3's emulation is
tests/test_torch_gqmv_design.py).

int4, as int3: a lane takes a chunk of 128 logical weights (64 bytes); a
half-warp of 16 lanes a piece of 16 chunks of one row; a CTA 16 pieces,
``STREAM_PIECES // pieces`` rows of ``pieces`` pieces each. Exact int32
group sums; each lane's terms s * (ws * xs) left to right (at GS 256 a group
is two lanes' chunks, summed as int32 and scaled on the even lane), the 16
lanes of a piece as a pairwise tree, a row's pieces left to right.

fp8 and int8, in blocks: a block is ``BLOCK_ROWS`` (16) rows, a CTA of a grid
of as many as the card runs at once (``stream_block_grid``: each CTA but the
last as many blocks as the others) takes blocks blockIdx.x, blockIdx.x +
gridDim.x, ..., and its warp w a block's 256-column slices w, w + 8, ...;
lane (gid, t) 16 bytes of rows gid and gid + 8 at columns 16t .. 16t + 15
of each of a slice's four 64-column spans. A group is GS / 64 whole spans
(GS >= 64), or at GS 16 and 32 the lanes t of one group within a span.
fp8, on the f16 tensor cores: mma j of a span takes the lane's columns
4j .. 4j + 3, so that one k16 step covers columns {64p + 16t + 4j + b}
(the other groups' lanes' activations zeroed); a group's sum is the f32
accumulator of its k16 steps in order, each step's 16 products exact (e4m3
and int8 are exact in f16, their products in f32); the emulation adds each
step's exact sum to the f32 sum with one rounding (the tensor core's order
within a step is its own). int8, by ``__dp4a``: each lane's 16 bytes of a
row give an exact int32 sum, and a group's lanes t are added by an xor
butterfly; every partial sum is an integer below 127^2 * 256 < 2^24, exact
in the emulation's f32 in any order. Then each slice's group terms
s * (ws * xs) left to right, a row's slices left to right.

Tolerances: int4 and int8 rtol 1e-5, atol 1e-5 * max|ref| (exact group
sums; only the f32 order across groups differs); fp8 rtol 5e-4, atol 1e-4
(the card tests' and the reference's for its fp8 kernel: the group sums are
f32 sums in another order than the oracle's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gqmv import gqmv_pallas  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import gqmv  # noqa: E402

# TinyLlama's quantized projections: (name, m, n)
PROJECTIONS = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w13", 11264, 2048),
               ("w2", 2048, 5632), ("classifier", 32000, 2048))
CHUNK = gqmv.STREAM_CHUNK
FP8_NANS = (0x7F, 0xFF)


def byte_perm(a, b, sel: int):
    """CUDA's __byte_perm on uint32 arrays (selector nibbles 0..7, no sign
    mode): result byte i is byte (sel >> 4i) & 7 of the pair (b:a)."""
    pair = [(a >> (8 * k)) & 0xFF for k in range(4)] + [(b >> (8 * k)) & 0xFF for k in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= pair[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def unpack_int4_chunks(raw: np.ndarray) -> np.ndarray:
    """The kernel's StreamInt4::unpack on (..., 64) bytes -> (..., 128) int8:
    sixteen little-endian 32-bit words, each unpack_int4_word's even and odd
    nibbles interleaved back by __byte_perm 0x5140 / 0x7362, sign-extended
    as (v ^ 8) - 8 a byte."""
    u = np.ascontiguousarray(raw).view("<u4").astype(np.uint32)        # (..., 16)
    even, odd = u & np.uint32(0x0F0F0F0F), (u >> 4) & np.uint32(0x0F0F0F0F)
    words = np.stack([byte_perm(even, odd, 0x5140), byte_perm(even, odd, 0x7362)], axis=-1)
    nib = np.ascontiguousarray(words).view(np.uint8).astype(np.int16)  # (..., 16, 2 * 4)
    return ((nib ^ 8) - 8).astype(np.int8).reshape(*raw.shape[:-1], 128)


def int4_stream_emulation(wp, ws, xq, xs, gs, block_rows=4096):
    """(out (m,) f32, how often each (row, group) term was taken (m, ng))."""
    m = wp.shape[0]
    n = xq.shape[0]
    ng, nchunks = n // gs, n // CHUNK
    lane_acc = np.zeros((m, nchunks), np.float32)
    for r0 in range(0, m, block_rows):
        r1 = min(m, r0 + block_rows)
        w = unpack_int4_chunks(wp[r0:r1].reshape(r1 - r0, nchunks, 64)).reshape(r1 - r0, n)
        # exact int32 group sums (every partial sum an integer below 2^24)
        s = (w.astype(np.float32) * xq.astype(np.float32)).reshape(r1 - r0, ng, gs).sum(-1)
        terms = s * (ws[r0:r1] * xs[None, :])    # s * (ws * xs), f32
        acc = np.zeros((r1 - r0, nchunks), np.float32)
        if gs <= CHUNK:
            t = terms.reshape(r1 - r0, nchunks, CHUNK // gs)
            for g in range(CHUNK // gs):         # left to right
                acc = acc + t[:, :, g]
        else:
            acc[:, 0::2] = terms                 # the even lane scales
        lane_acc[r0:r1] = acc
    # the CTAs' half-warps and lanes: which (row, chunk) each live lane takes
    pieces, rows, ctas = gqmv.stream_plan(m, n)
    h = np.arange(gqmv.STREAM_PIECES)
    lane = np.arange(gqmv.STREAM_LANES)
    row = np.arange(ctas)[:, None, None] * rows + (h // pieces)[None, :, None]
    chunk = ((h % pieces)[:, None] * gqmv.STREAM_LANES + lane[None, :])[None]
    row, chunk = np.broadcast_arrays(row, chunk)
    live = ((h // pieces)[None, :, None] < rows) & (row < m) & (chunk < nchunks)
    row, chunk = row[live], chunk[live]
    count = np.zeros((m, ng), np.int64)
    if gs <= CHUNK:
        per = CHUNK // gs
        groups = chunk[:, None] * per + np.arange(per)[None, :]
        np.add.at(count, (np.repeat(row, per), groups.ravel()), 1)
    else:
        even = chunk % 2 == 0
        np.add.at(count, (row[even], chunk[even] // 2), 1)
    # a piece's 16 lanes as a pairwise tree (lanes past the row hold 0), then
    # the row's pieces left to right
    part = np.zeros((m, pieces * gqmv.STREAM_LANES), np.float32)
    part[:, :nchunks] = lane_acc
    part = part.reshape(m, pieces, gqmv.STREAM_LANES)
    while part.shape[-1] > 1:
        part = part[..., 0::2] + part[..., 1::2]
    out = part[:, 0, 0].copy()
    for p in range(1, pieces):
        out = out + part[:, p, 0]
    return out, count


def block_units(gs: int):
    """A slice's groups as (first span, spans, lanes t) in order: GS / 64
    whole spans (GS >= 64) or, at GS 16 and 32, the GS / 16 lanes of one
    group within a span."""
    if gs >= 64:
        return [(p0, gs // 64, range(4)) for p0 in range(0, 4, gs // 64)]
    lanes = gs // 16
    return [(p, 1, range(q * lanes, (q + 1) * lanes)) for p in range(4)
            for q in range(4 // lanes)]


def block_stream_emulation(fmt, wb, ws, xq, xs, gs, block_rows=4096):
    """(out (m,) f32, how often each (row, group) term was taken (m, ng)) of
    the streamed block GQMV on e4m3 bytes (fp8) or int8 values wb (m, n)."""
    m, n = wb.shape
    ng = n // gs
    slices, ctas = gqmv.stream_block_plan(m, n)
    width = slices * gqmv.BLOCK_SLICE
    x = np.zeros(width)
    x[:n] = xq
    # every block once, by CTA c of a grid (at most two CTAs an SM of an
    # H100's 132 here): c, c + grid, ...; every slice once, by warp w of 8:
    # w, w + 8, ...
    grid = gqmv.stream_block_grid(ctas, 2 * 132)
    assert sorted(b for c in range(grid) for b in range(c, ctas, grid)) == list(range(ctas))
    taken = sorted(s for w in range(gqmv.STREAM_THREADS // 32)
                   for s in range(w, slices, gqmv.STREAM_THREADS // 32))
    assert taken == list(range(slices))
    # the steps a lane's 16 columns are summed in: fp8 four k16 mmas of 4
    # columns each; int8 (exact in any split) one
    steps = 4 if fmt == "fp8" else 1
    count = np.zeros((m, ng), np.int64)
    out = np.zeros(m, np.float32)
    for r0 in range(0, ctas * gqmv.BLOCK_ROWS, block_rows):
        r1 = min(m, r0 + block_rows)
        if r0 >= m:
            break
        w = np.zeros((r1 - r0, width))
        if fmt == "fp8":
            w[:, :n] = torch.from_numpy(wb[r0:r1]).view(torch.float8_e4m3fn).double().numpy()
        else:
            w[:, :n] = wb[r0:r1]
        # exact products, by (slice, span p, lane t, mma j, column b)
        prod = (w * x[None, :]).reshape(r1 - r0, slices, 4, 4, steps, 16 // steps)
        row = np.zeros(r1 - r0, np.float32)
        for s in taken:
            acc = np.zeros(r1 - r0, np.float32)
            for p0, spans, lanes in block_units(gs):
                g = (s * gqmv.BLOCK_SLICE + 64 * p0) // gs + (lanes[0] * 16 % 64) // gs
                c = np.zeros(r1 - r0, np.float32)
                for p in range(p0, p0 + spans):
                    for j in range(steps):        # one mma step: exact, then one rounding
                        step = prod[:, s, p, list(lanes), j, :].sum(axis=(1, 2))
                        c = (c.astype(np.float64) + step).astype(np.float32)
                if g < ng:
                    acc = acc + c * (ws[r0:r1, g] * xs[g])
                    count[r0:r1, g] += 1
            row = acc if s == 0 else row + acc
        out[r0:r1] = row
    return out, count


def _inputs(fmt, m, n, gs, seed):
    """Random int4 bytes (every nibble value -8..7), e4m3 bytes (every value
    but the NaNs) or int8 values (-127..127), positive scales, int8
    activations."""
    rng = np.random.default_rng(seed)
    if fmt == "int4":
        wp = rng.integers(-128, 128, size=(m, n // 2), dtype=np.int8)
    elif fmt == "int8":
        wp = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    else:
        wp = rng.integers(0, 256, size=(m, n), dtype=np.uint8)
        wp[np.isin(wp, FP8_NANS)] = 0x7E                       # 448, the largest value
    ws = (rng.random((m, n // gs), dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    xq = rng.integers(-127, 128, size=(n,), dtype=np.int8)
    xs = (rng.random(n // gs, dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    return wp, ws, xq, xs


def _reference(fmt, wp, ws, xq, xs, gs):
    if fmt == "int8":
        return np.asarray(jref.gqmv_ref(jnp.asarray(wp), jnp.asarray(ws), jnp.asarray(xq),
                                        jnp.asarray(xs), group_size=gs))
    if fmt == "int4":
        return np.asarray(jref.gqmv_int4_ref(jnp.asarray(wp), jnp.asarray(ws), jnp.asarray(xq),
                                             jnp.asarray(xs), group_size=gs))
    w8 = jax.lax.bitcast_convert_type(jnp.asarray(wp), jnp.float8_e4m3fn)
    return np.asarray(jref.gqmv_fp8_ref(w8, jnp.asarray(ws), jnp.asarray(xq), jnp.asarray(xs),
                                        group_size=gs))


TOL = {"int4": lambda want: dict(rtol=1e-5, atol=1e-5 * np.abs(want).max()),
       "int8": lambda want: dict(rtol=1e-5, atol=1e-5 * np.abs(want).max()),
       "fp8": lambda want: dict(rtol=5e-4, atol=1e-4)}


@pytest.mark.parametrize("gs", gqmv.GROUP_SIZES)
@pytest.mark.parametrize("name,m,n", PROJECTIONS, ids=[p[0] for p in PROJECTIONS])
@pytest.mark.parametrize("fmt", ("int4", "fp8", "int8"))
def test_stream_partition_covers_every_group_and_matches_reference(fmt, name, m, n, gs):
    assert gqmv.gqmv_design(n, fmt) == "stream"
    wp, ws, xq, xs = _inputs(fmt, m, n, gs, seed=m + gs)
    if fmt == "int4":
        got, count = int4_stream_emulation(wp, ws, xq, xs, gs)
    else:
        got, count = block_stream_emulation(fmt, wp, ws, xq, xs, gs)
    assert (count == 1).all()                        # every group's term exactly once
    want = _reference(fmt, wp, ws, xq, xs, gs)
    np.testing.assert_allclose(got, want, **TOL[fmt](want))
    if fmt == "int8":                                # and the TPU kernel, interpreted
        pallas = np.asarray(gqmv_pallas(jnp.asarray(wp), jnp.asarray(ws), jnp.asarray(xq),
                                        jnp.asarray(xs), group_size=gs, interpret=True))
        np.testing.assert_allclose(got, pallas, **TOL[fmt](pallas))


def test_a_64_byte_int4_chunk_unpacks_like_unpack_int4():
    rng = np.random.default_rng(0)
    raw = rng.integers(-128, 128, size=(500, gqmv.STREAM_CHUNK_BYTES["int4"]), dtype=np.int8)
    want = quant.unpack_int4(torch.from_numpy(raw)).numpy()
    assert want.shape == (500, 128)
    np.testing.assert_array_equal(unpack_int4_chunks(raw), want)


# the families' rows with an odd number of groups at GS 256, cut to a few
# rows each: gemma2-2b's d 2304 (9 groups) and deepseek-coder-33b's d_ff
# 19200 (75 groups); the TinyLlama rows above have 8 and 22
ODD_ROWS = (("gemma2_d2304", 24, 2304), ("deepseek_w2_19200", 8, 19200))


@pytest.mark.parametrize("name,m,n", ODD_ROWS, ids=[r[0] for r in ODD_ROWS])
@pytest.mark.parametrize("fmt", ("int4", "fp8", "int8"))
def test_stream_partition_at_odd_group_counts(fmt, name, m, n):
    gs = 256
    assert gqmv.gqmv_design(n, fmt) == "stream" and (n // gs) % 2 == 1
    wp, ws, xq, xs = _inputs(fmt, m, n, gs, seed=n + m)
    if fmt == "int4":
        got, count = int4_stream_emulation(wp, ws, xq, xs, gs)
    else:
        got, count = block_stream_emulation(fmt, wp, ws, xq, xs, gs)
    assert (count == 1).all()
    want = _reference(fmt, wp, ws, xq, xs, gs)
    np.testing.assert_allclose(got, want, **TOL[fmt](want))
