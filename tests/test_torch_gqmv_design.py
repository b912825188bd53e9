"""The streamed int3 GQMV design (``csrc/gqmm.cu``, ``gqmv_stream_kernel``):
its partition and order of f32 sums emulated in numpy on the CPU and held
against the reference package's oracle ``gqmv_int3_ref``; its 48-byte
unpacking against the port's ``unpack_int3``; its constants and the choice
between the streamed designs (int4, int3, fp8, int8) and the first design
against the CUDA source (the kernels themselves run in
tests/test_torch_cuda.py on the card; int4's, fp8's and int8's emulation is
tests/test_torch_gqmv_stream_formats.py).

The partition: a lane takes a chunk of 128 logical weights (48 bytes); a
half-warp of 16 lanes a piece of 16 chunks of one row; a CTA 16 pieces,
``STREAM_PIECES // pieces`` rows of ``pieces`` pieces each. The order: each
lane's group terms s * (ws * xs) left to right (at GS 256 a group is two
lanes' chunks, summed as int32 and scaled on the even lane), the 16 lanes of
a piece as a pairwise tree, a row's pieces left to right. Tolerance: the
GQMV one of the card tests, rtol 1e-5 and atol 1e-5 * max|ref| (exact int32
group sums; only the order of the f32 sum across groups differs).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import gqmv  # noqa: E402

SRC = (Path(gqmv.__file__).resolve().parents[1] / "csrc" / "gqmm.cu").read_text()
# TinyLlama's quantized projections: (name, m, n)
PROJECTIONS = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w13", 11264, 2048),
               ("w2", 2048, 5632), ("classifier", 32000, 2048))
CHUNK_BYTES = gqmv.STREAM_CHUNK_BYTES["int3"]


def _sext3(w):
    """The four 3-bit fields in bits 0..11 of each uint32 -> int8 (..., 4)."""
    f = (w[..., None] >> (3 * np.arange(4, dtype=np.uint32))) & 7
    return ((f.astype(np.int16) ^ 4) - 4).astype(np.int8)


def unpack_chunks(raw: np.ndarray) -> np.ndarray:
    """The kernel's StreamInt3::unpack on (..., 48) uint8 chunks -> (..., 128)
    int8: twelve little-endian 32-bit words, each 12 bytes four 24-bit words
    (a, (a >> 24) | (b << 8), (b >> 16) | (c << 16), c >> 8), each 24-bit
    word two sext3 of 12 bits."""
    u = np.ascontiguousarray(raw).view("<u4").astype(np.uint32)      # (..., 12)
    a, b, c = u[..., 0::3], u[..., 1::3], u[..., 2::3]               # (..., 4)
    w24 = np.stack([a, (a >> 24) | (b << 8), (b >> 16) | (c << 16), c >> 8], axis=-1)
    halves = np.stack([_sext3(w24), _sext3(w24 >> 12)], axis=-2)     # (..., 4, 4, 2, 4)
    return halves.reshape(*raw.shape[:-1], 128)


def stream_gqmv_emulation(wp, ws, xq, xs, gs, block_rows=4096):
    """(out (m,) f32, how often each (row, group) term was taken (m, ng))."""
    m = wp.shape[0]
    n = xq.shape[0]
    ng, nchunks = n // gs, n // gqmv.STREAM_CHUNK
    pieces, rows, ctas = gqmv.stream_plan(m, n)
    x = xq.astype(np.float32).reshape(ng, gs)
    lane_acc = np.zeros((m, pieces * gqmv.STREAM_LANES), np.float32)
    count = np.zeros((m, ng), np.int64)
    # the CTAs' half-warps and lanes: (row of the CTA, piece) and chunk
    h = np.arange(gqmv.STREAM_PIECES)
    rl, piece = h // pieces, h % pieces
    lane = np.arange(gqmv.STREAM_LANES)
    chunk = piece[:, None] * gqmv.STREAM_LANES + lane[None, :]        # (16, 16)
    for r0 in range(0, m, block_rows):
        r1 = min(m, r0 + block_rows)
        w = unpack_chunks(wp[r0:r1].reshape(r1 - r0, nchunks, CHUNK_BYTES)).reshape(r1 - r0, n)
        # exact int32 group sums (every partial sum is an integer below 2^24)
        s = np.einsum("mgk,gk->mg", w.reshape(r1 - r0, ng, gs).astype(np.float32), x)
        terms = s * (ws[r0:r1] * xs[None, :])                         # s * (ws * xs), f32
        if gs <= gqmv.STREAM_CHUNK:
            per = gqmv.STREAM_CHUNK // gs
            t = terms.reshape(r1 - r0, nchunks, per)
            acc = np.zeros((r1 - r0, nchunks), np.float32)
            for g in range(per):                                      # left to right
                acc = acc + t[:, :, g]
        else:
            acc = np.zeros((r1 - r0, nchunks), np.float32)
            acc[:, 0::2] = terms                                      # the even lane scales
        lane_acc[r0:r1, :nchunks] = acc
    out = np.zeros(m, np.float32)
    for cta in range(ctas):
        for hh in range(gqmv.STREAM_PIECES):
            row = cta * rows + rl[hh]
            live = (rl[hh] < rows) & (row < m) & (chunk[hh] < nchunks)
            if not live.any():
                continue
            for c in chunk[hh][live]:
                groups = ([c * (gqmv.STREAM_CHUNK // gs) + g
                           for g in range(gqmv.STREAM_CHUNK // gs)]
                          if gs <= gqmv.STREAM_CHUNK else ([c // 2] if c % 2 == 0 else []))
                count[row, groups] += 1
        for r in range(rows):
            row = cta * rows + r
            if row >= m:
                continue
            v = None
            for p in range(pieces):                                   # pieces left to right
                part = lane_acc[row, p * gqmv.STREAM_LANES:(p + 1) * gqmv.STREAM_LANES]
                while part.shape[-1] > 1:                             # the 16 lanes' tree
                    part = part[0::2] + part[1::2]
                v = part[0] if v is None else np.float32(v + part[0])
            out[row] = v
    return out, count


def _inputs(m, n, gs, seed):
    """Random packed int3 bytes (every field value -4..3), positive scales,
    int8 activations."""
    rng = np.random.default_rng(seed)
    wp = rng.integers(0, 256, size=(m, n // 8 * 3), dtype=np.uint8)
    ws = (rng.random((m, n // gs), dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    xq = rng.integers(-127, 128, size=(n,), dtype=np.int8)
    xs = (rng.random(n // gs, dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    return wp, ws, xq, xs


@pytest.mark.parametrize("gs", gqmv.GROUP_SIZES)
@pytest.mark.parametrize("name,m,n", PROJECTIONS, ids=[p[0] for p in PROJECTIONS])
def test_stream_partition_covers_every_group_and_matches_reference(name, m, n, gs):
    assert gqmv.gqmv_design(n, "int3") == "stream"
    wp, ws, xq, xs = _inputs(m, n, gs, seed=m + gs)
    got, count = stream_gqmv_emulation(wp, ws, xq, xs, gs)
    assert (count == 1).all()                        # every group's term exactly once
    want = np.asarray(jref.gqmv_int3_ref(jnp.asarray(wp), jnp.asarray(ws), jnp.asarray(xq),
                                         jnp.asarray(xs), group_size=gs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_stream_plan_of_tinyllama_projections():
    """2048-wide rows are one piece (16 rows a CTA, two a warp); w2's 5632 are
    44 chunks, three pieces, five rows a CTA; the widest row the design takes
    is 16 pieces, one row a CTA."""
    assert gqmv.stream_plan(2048, 2048) == (1, 16, 128)
    assert gqmv.stream_plan(32000, 2048) == (1, 16, 2000)
    assert gqmv.stream_plan(2048, 5632) == (3, 5, 410)
    assert gqmv.stream_plan(3, gqmv.STREAM_MAX_N) == (16, 1, 3)
    assert gqmv.stream_smem_bytes(5632, 5632 // 16) == 5632 + 4 * 352 + 4 * 16


def test_a_48_byte_chunk_unpacks_like_unpack_int3():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=(500, CHUNK_BYTES), dtype=np.uint8)
    want = quant.unpack_int3(torch.from_numpy(raw)).numpy()
    assert want.shape == (500, 128)
    np.testing.assert_array_equal(unpack_chunks(raw), want)


def test_design_choice_by_shape_and_alignment():
    """The streamed design takes 16-byte aligned int3, int4, fp8 and int8
    rows with n a multiple of 128 up to STREAM_MAX_N (or up to a smaller
    width a timing run set); a misaligned layer slice of a stacked leaf, n
    1056 at GS 32 and wider rows run the first design."""
    for fmt in ("int3", "int4", "fp8", "int8"):
        for _, _, n in PROJECTIONS:
            assert gqmv.gqmv_design(n, fmt) == "stream"
        assert gqmv.gqmv_design(1056, fmt) == "first"
        assert gqmv.gqmv_design(gqmv.STREAM_MAX_N + 128, fmt) == "first"
        assert gqmv.gqmv_design(2048, fmt, aligned=False) == "first"
    for fmt, pack in (("int3", 8 / 3), ("int4", 2)):
        leaf = quant.quantize(torch.randn(3, 9, 48), 16, fmt)
        for i in range(3):
            wq = leaf[i].qvalues
            aligned = wq.data_ptr() % 16 == 0
            assert gqmv.gqmv_design(round(wq.shape[1] * pack), fmt, aligned) == "first"
        assert not all(leaf[i].qvalues.data_ptr() % 16 == 0 for i in range(3))
    for _, _, n in PROJECTIONS:
        assert gqmv.gqmv_design(n, "int8") == "stream"
        assert gqmv.gqmv_design(n, "int8", stream_max_n=0) == "first"
        assert gqmv.gqmv_design(n, "int8", stream_max_n=n) == "stream"
        assert gqmv.gqmv_design(n, "int8", stream_max_n=n - 128) == "first"


def _cuda_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_stream_constants_mirror_the_cuda_source():
    assert _cuda_int("kStreamThreads") == gqmv.STREAM_THREADS
    assert _cuda_int("kStreamLanes") == gqmv.STREAM_LANES
    assert _cuda_int("kStreamChunk") == gqmv.STREAM_CHUNK
    assert "kStreamPieces = kStreamThreads / kStreamLanes;" in SRC
    assert gqmv.STREAM_PIECES == gqmv.STREAM_THREADS // gqmv.STREAM_LANES
    assert "kStreamMaxN = kStreamPieces * kStreamLanes * kStreamChunk;" in SRC
    assert "static constexpr int kVecs = 3;" in SRC and CHUNK_BYTES == 3 * 16
    # each loader's 16-byte loads a lane; the tensor-core variant's blocks
    # and warp slices
    for loader, fmt in (("StreamInt3", "int3"), ("StreamInt4", "int4"), ("StreamFp8", "fp8"),
                        ("StreamInt8", "int8")):
        body = SRC[SRC.index(f"struct {loader} {{"):]
        body = body[:body.index("\n};")]
        assert f"static constexpr int kVecs = {gqmv.STREAM_CHUNK_BYTES[fmt] // 16};" in body
    assert _cuda_int("kBlockRows") == gqmv.BLOCK_ROWS
    assert _cuda_int("kBlockSlice") == gqmv.BLOCK_SLICE
    # the block variant's loaders' staged activation bytes, and its grid:
    # as many CTAs as the card holds, each but the last as many blocks
    for loader, fmt in (("StreamFp8", "fp8"), ("StreamInt8", "int8")):
        body = SRC[SRC.index(f"struct {loader} {{"):]
        body = body[:body.index("\n};")]
        assert f"static constexpr int kXBytes = {gqmv.STREAM_X_BYTES[fmt]};" in body
        assert "static constexpr bool kBlock = true;" in body
    assert "const int per = (blocks + cap - 1) / cap;" in SRC
    assert "cfg.gridDim = dim3((blocks + per - 1) / per);" in SRC
    for blocks in range(1, 3000, 37):
        for cap in (132, 264, 396):
            grid = gqmv.stream_block_grid(blocks, cap)
            per = -(-blocks // grid)
            assert grid <= cap and (grid - 1) * per < blocks <= grid * per
            assert per == -(-blocks // cap)
    # the choice by pointer and shape (the widest row a timing knob can only
    # narrow), and the CTAs' shared memory
    assert ("(reinterpret_cast<uintptr_t>(wq) & 15) == 0 && n % kStreamChunk == 0 &&\n"
            "         n <= g_stream_max_n;") in SRC
    assert "int g_stream_max_n = kStreamMaxN;" in SRC
    assert "g_stream_max_n = n < kStreamMaxN ? n : kStreamMaxN;" in SRC
    assert "return (size_t)n + 4 * (size_t)ng + 4 * kStreamPieces;" in SRC
    assert ("return (size_t)xbytes * n + 4 * (size_t)ng +\n"
            "         4 * (size_t)kBlockRows * ((n + kBlockSlice - 1) / kBlockSlice);") in SRC
    assert gqmv.stream_smem_bytes(5632, 22, "fp8") == 2 * 5632 + 4 * 22 + 4 * 16 * 22
    assert gqmv.stream_smem_bytes(5632, 22, "int8") == 5632 + 4 * 22 + 4 * 16 * 22
    # every format's GQMV runs it, with its first design for the other rows
    for fmt, loader, first in (("int4", "StreamInt4", "Int4Weights"),
                               ("int3", "StreamInt3", "Int3Weights"),
                               ("fp8", "StreamFp8", "Fp8Weights"),
                               ("int8", "StreamInt8", "Int8Weights")):
        assert f"GQMV_ENTRY_POINT({fmt}, (run_gqmv_stream<{loader}, {first}>))" in SRC
