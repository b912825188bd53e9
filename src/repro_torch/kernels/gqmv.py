"""CUDA GQMV/GQMM kernels for Hopper: checked wrappers and launch counts.

Counterpart of ``repro/kernels/gqmv.py``. The kernels themselves are in
``csrc/gqmm.cu`` (their design and bound are noted there), one pair per
weight format:

  gqmv_cuda(fmt=...)  <- ``gqmv_pallas`` / ``gqmv_{int4,int3,fp8}_pallas``
                         (paper Alg. 1, batch-1 matrix-vector)
  gqmm_cuda(fmt=...)  <- ``gqmm_pallas`` / ``gqmm_{int4,int3,fp8}_pallas``
                         (batched: prefill b = tokens, decode b = batch)

Every GQMM runs one of two designs on the tensor cores, chosen by b in
``csrc/gqmm.cu`` (``run_gqmm_tc``) and mirrored by :func:`gqmm_design`:
the small one (decode: activations staged in shared memory, weights
streamed into ``mma.sync`` fragments) for b <= ``SMALL_MAX_B``, the large
one (prefill: a ring of weight and activation tiles, filled by the TMA
unit, into ``wgmma``) above it. int8, int4 and int3 run the int8 tensor
cores (int4 and int3 weights unpacked to int8 on the way); fp8 runs the
f16 ones (e4m3 weights and int8 activations are exact in f16, their
products exact in f32). int4 and int3 rows the large design's ring cannot
stream run the first design (one warp an output row, ``__dp4a``), as the
GQMV rows the streamed design cannot take do.

Every GQMV format runs a streamed design where its rows allow it
(:func:`gqmv_design`: 16-byte aligned storage, n a multiple of
``STREAM_CHUNK`` up to ``STREAM_MAX_N``), else the first design. A lane
loads 128 logical weights (``STREAM_CHUNK_BYTES``) as 16-byte loads, issued
before it waits for anything, and the activations are staged in shared
memory once a CTA. int4 and int3 (:func:`stream_plan`): a lane's 64 or 48
bytes are one row's chunk, a half-warp takes a 16-chunk piece of a row, a
CTA of 8 warps 16 pieces; exact int32 group sums by ``__dp4a``; the f32
order: a lane's groups left to right (at GS 256 the even lane's half plus
the odd lane's, scaled on the even lane), the piece's 16 lanes as a pairwise
tree, a row's pieces left to right. fp8 and int8 (:func:`stream_block_plan`):
a block is ``BLOCK_ROWS`` rows, warp w of a CTA takes its ``BLOCK_SLICE``-column
slices w, w + 8, ..., lane (gid, t) 16 bytes of rows gid and gid + 8 at each
of a slice's four 64-column spans (a warp load is 8 rows x 64 contiguous
bytes); a persistent grid of as many CTAs as the card holds at once (each
taking as many blocks as the others, but the last) walks the blocks and
requests each next slice before it computes the current one. fp8's group
dots run on the f16 tensor cores (``mma.sync`` m16n8k16, f32 sums;
activations staged as f16), int8's on the CUDA cores (``__dp4a`` and an xor
butterfly over a group's lanes: exact int32 sums; activations staged as
int8 by ``cp.async``). The f32 order: a slice's group terms s * (ws * xs)
left to right, a row's slices left to right. This kernel is a programmatic
dependent launch: it issues its first weight loads before it waits for the
kernel before it on the stream, so GQMV's weights and weight scales must
not be the output of the kernel launched right before it (model weights,
quantized once, never are).

``wq`` is the format's storage array: int8 (m, n) for int8, packed int8
(m, n/2) for int4, packed uint8 (m, 3n/8) for int3, float8_e4m3fn (m, n)
for fp8. Activations are int8 in every format. Each wrapper takes CUDA
tensors only: it checks device, dtype, shape, contiguity and the alignment
the kernel's loads need, and raises on anything else, allocates the f32
output with ``torch.empty``, launches on the current stream, raises if the
launch reports a CUDA error, and adds one to ``LAUNCHES`` under
``gqmv_<fmt>`` / ``gqmm_<fmt>`` for every launch. The plain versions are
``kernels/ref.py``; ``kernels/ops.py`` chooses between the two by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant import get_format
from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import MAX_SMEM

GROUP_SIZES = (16, 32, 64, 128, 256)

# weight format -> the byte alignment of the 16-weight row chunk a lane
# loads (16 bytes of int8 or fp8, 8 of int4, 6 of int3 as 16-bit words)
WEIGHT_FORMATS: dict[str, int] = {"int8": 16, "int4": 8, "int3": 2, "fp8": 16}

# csrc/gqmm.cu, GQMM. SMALL_MAX_B is the cut-over, set from the times of
# both designs at b = 8 and 16 (chip_smoke.py's cut-over rows, PERF.md).
# The small design: weight rows a CTA, warps a CTA (one unit of whole
# groups each per round), logical weights a k-span, k-spans of loads in
# flight a round, groups a unit at most. The large design: batch rows a
# CTA, weight rows a CTA (WIDE_ROWS where that gives every SM a CTA, else
# NARROW_ROWS), bytes of the contraction a stage, stages of the ring, groups
# whose scales a stage holds at most, the floats a row of them takes, the
# alignment of a 128-byte-swizzled tile, and fp8's f16 activation tile (two
# atoms of 128-byte rows) and stages (one fewer, so that two 64-row CTAs
# still fit an SM).
SMALL_MAX_B = 16
SMALL_ROWS, SMALL_WARPS, SPAN, UNROLL, UNIT_GROUPS = 16, 8, 64, 4, 4
LARGE_COLS, WIDE_ROWS, NARROW_ROWS, BK, STAGES = 64, 128, 64, 128, 5
FP8_STAGES = 4
STAGE_GROUPS, SCALE_STRIDE, SWIZZLE_ALIGN = 8, 9, 1024
X_ATOM_BYTES = LARGE_COLS * 128
SMS = 132
TC_FORMATS = ("int8", "int4", "int3", "fp8")
# bytes a weight row takes in a stage of the ring, as stored (int4 and int3
# packed, then unpacked to an int8 tile), and the formats whose rows the
# ring may not stream (then the first design runs)
SLICE_BYTES = {"int8": BK, "int4": BK // 2, "int3": BK // 8 * 3, "fp8": BK}
PACKED = ("int4", "int3")

# csrc/gqmm.cu, the streamed GQMV design: threads a CTA, lanes a piece (half
# a warp), pieces a CTA, logical weights a lane (a chunk), the widest row it
# takes (16 pieces of 16 chunks), and the bytes a lane loads by format (int4
# and int3: one row's chunk; fp8 and int8: 16 bytes of two rows at four
# spans). The block variant's (fp8, int8) block is BLOCK_ROWS rows (an mma's
# 16), a warp takes BLOCK_SLICE columns of them at a time (four 64-column
# spans), and a CTA stages the activations at STREAM_X_BYTES bytes each
# (fp8: f16; int8: int8).
STREAM_THREADS, STREAM_LANES, STREAM_PIECES, STREAM_CHUNK = 256, 16, 16, 128
STREAM_MAX_N = STREAM_PIECES * STREAM_LANES * STREAM_CHUNK
STREAM_CHUNK_BYTES = {"int3": 48, "int4": 64, "fp8": 128, "int8": 128}
BLOCK_ROWS, BLOCK_SLICE = 16, 256
STREAM_X_BYTES = {"fp8": 2, "int8": 1}


def gqmv_design(n: int, fmt: str = "int3", aligned: bool = True,
                stream_max_n: int = STREAM_MAX_N) -> str:
    """The GQMV design for rows of n logical weights (``run_gqmv_stream``):
    "stream" when the storage is 16-byte ``aligned`` and n a multiple of
    STREAM_CHUNK up to ``stream_max_n`` (the library's STREAM_MAX_N unless a
    timing run moved it: :func:`set_stream_max_n`), else "first"."""
    ok = (fmt in STREAM_CHUNK_BYTES and aligned and n % STREAM_CHUNK == 0
          and n <= min(stream_max_n, STREAM_MAX_N))
    return "stream" if ok else "first"


def stream_plan(m: int, n: int) -> tuple[int, int, int]:
    """(pieces a row, rows a CTA, CTAs) of the streamed int4 / int3 GQMV."""
    pieces = -(-(n // STREAM_CHUNK) // STREAM_LANES)
    rows = STREAM_PIECES // pieces
    return pieces, rows, -(-m // rows)


def stream_block_plan(m: int, n: int) -> tuple[int, int]:
    """(BLOCK_SLICE-column slices a row, blocks of BLOCK_ROWS rows) of the
    streamed fp8 and int8 GQMV; warp w of a CTA takes slices w, w + 8, ...
    of each of its blocks, a CTA blocks blockIdx.x, blockIdx.x + gridDim.x,
    ..."""
    return -(-n // BLOCK_SLICE), -(-m // BLOCK_ROWS)


def stream_block_grid(blocks: int, cap: int) -> int:
    """CTAs of the fp8 / int8 block kernel for ``blocks`` blocks when the card
    holds ``cap`` at once: every CTA but the last takes as many blocks as
    the others, ceil(blocks / cap)."""
    per = -(-blocks // cap)
    return -(-blocks // per)


def stream_smem_bytes(n: int, ng: int, fmt: str = "int3") -> int:
    """Dynamic shared memory of a streamed CTA. int4 / int3: the activations,
    their scales, one partial sum a piece. fp8 / int8: the activations (as
    f16 / int8), their scales, one term a row a slice."""
    if fmt in STREAM_X_BYTES:
        slices, _ = stream_block_plan(1, n)
        return STREAM_X_BYTES[fmt] * n + 4 * ng + 4 * BLOCK_ROWS * slices
    return n + 4 * ng + 4 * STREAM_PIECES


# launches per kernel; a run zeroes these, drives the model, and reads them
LAUNCHES: dict[str, int] = {f"{kind}_{fmt}": 0 for fmt in WEIGHT_FORMATS
                            for kind in ("gqmv", "gqmm")}

_LIB: list[ctypes.CDLL] = []


def small_x_stride(n: int) -> int:
    """Bytes between staged activation rows of the small design."""
    spans = -(-n // SPAN)
    return -(-spans * SPAN // 128) * 128 + 64


def small_smem_bytes(tiles8: int, n: int, ng: int) -> int:
    """Dynamic shared memory of a small-design CTA with ``tiles8`` 8-row
    tiles of batch rows, as ``csrc/gqmm.cu`` sizes it: the activation rows,
    their scales, the CTA's weight scales and one round's scaled terms."""
    return (8 * tiles8 * small_x_stride(n) + 4 * 8 * tiles8 * ng + 4 * SMALL_ROWS * ng
            + 4 * SMALL_WARPS * UNIT_GROUPS * SMALL_ROWS * 8 * tiles8)


def large_smem_bytes(fmt: str, rows: int) -> int:
    """Dynamic shared memory of a large-design CTA of ``rows`` weight rows:
    1 KB of room to align the base, STAGES stages (FP8_STAGES for fp8; the
    weights' slice as stored, int4 packed at 64 bytes a row, int3 at 48; the
    activations' slice; both scales; padded to 1 KB, where a
    128-byte-swizzled tile must start), for int4 and int3 the unpacked int8
    tile, for fp8 the f16
    activation tile, then an 8-byte mbarrier a stage."""
    stage = (rows * SLICE_BYTES[fmt] + LARGE_COLS * BK
             + 4 * (rows + LARGE_COLS) * SCALE_STRIDE)
    stage = -(-stage // SWIZZLE_ALIGN) * SWIZZLE_ALIGN
    stages = FP8_STAGES if fmt == "fp8" else STAGES
    return (SWIZZLE_ALIGN + stages * stage + (rows * BK if fmt in PACKED else 0)
            + (2 * X_ATOM_BYTES if fmt == "fp8" else 0) + 8 * stages)


def gqmm_design(b: int, m: int, n: int, group_size: int, fmt: str = "int8",
                aligned: bool = True, small_max_b: int = SMALL_MAX_B) -> tuple[str, int]:
    """(design, width) that GQMM runs for these shapes: ("small", 8-row
    tiles of batch rows), ("large", weight rows a CTA), or, for int4 and
    int3 rows the large design's ring cannot stream (storage not 16-byte
    ``aligned``, or n no multiple of BK), ("first", 0): the first design."""
    ng = n // group_size
    for tiles8 in (1, 2):
        if b <= min(small_max_b, 8 * tiles8) and small_smem_bytes(tiles8, n, ng) <= MAX_SMEM:
            return "small", tiles8
    if fmt in PACKED and (not aligned or n % BK):
        return "first", 0
    wide = -(-m // WIDE_ROWS) * -(-b // LARGE_COLS) >= SMS
    return "large", WIDE_ROWS if wide else NARROW_ROWS


def set_small_max_b(b: int) -> int:
    """Set the cut-over of the compiled GQMM (the library's, not
    ``SMALL_MAX_B``) and return the previous one: for timing both designs
    at one b. Both designs give the same int32 group sums and scaled terms
    (fp8: f32 group sums, in another order)."""
    return int(_lib().gqmm_set_small_max_b(int(b)))


def set_stream_max_n(n: int) -> int:
    """Set the widest row the compiled GQMV streams (at most STREAM_MAX_N; 0
    sends every row to the first design) and return the previous value: for
    timing both designs at one shape. Both keep the plain version's
    arithmetic; only the order of the f32 sums differs."""
    return int(_lib().gqmv_set_stream_max_n(int(n)))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = cuda_build.load("gqmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fmt in WEIGHT_FORMATS:
            mv, mm = getattr(lib, f"gqmv_{fmt}"), getattr(lib, f"gqmm_{fmt}")
            mv.argtypes = [p, p, p, p, p, i, i, i, i, p]
            mm.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            mv.restype = mm.restype = i
        for knob in (lib.gqmm_set_small_max_b, lib.gqmv_set_stream_max_n):
            knob.argtypes = [i]
            knob.restype = i
        _LIB.append(lib)
    return _LIB[0]


def _check(wq, ws, xq, xs, group_size: int, batched: bool, fmt: str) -> tuple[int, int, int]:
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(f"unknown weight format {fmt!r}; one of {tuple(WEIGHT_FORMATS)}")
    spec, align = get_format(fmt), WEIGHT_FORMATS[fmt]
    wdtype, pack, pack_storage = spec.storage_dtype, spec.pack, spec.pack_storage
    named = {"wq": wq, "ws": ws, "xq": xq, "xs": xs}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("wq, ws, xq and xs must be on one device")
    for name, want in (("wq", wdtype), ("ws", torch.float32),
                       ("xq", torch.int8), ("xs", torch.float32)):
        if named[name].dtype != want:
            raise TypeError(f"{name} must be {want} for {fmt} weights, got {named[name].dtype}")
    if xq.ndim != (2 if batched else 1):
        want_x = "(b, n)" if batched else "(n,)"
        raise ValueError(f"xq must be {want_x}, got shape {tuple(xq.shape)}")
    n = xq.shape[-1]
    if group_size not in GROUP_SIZES or n % group_size:
        raise ValueError(f"group_size {group_size} must be one of {GROUP_SIZES} "
                         f"and divide n={n}")
    if wq.ndim != 2 or wq.shape[1] != n // pack * pack_storage:
        raise ValueError(f"wq must be (m, {n // pack * pack_storage}) {fmt} storage for "
                         f"n={n}, got shape {tuple(wq.shape)}")
    m = wq.shape[0]
    if m < 1:
        raise ValueError("wq must have at least one row")
    ng = n // group_size
    if tuple(ws.shape) != (m, ng):
        raise ValueError(f"ws must be {(m, ng)}, got {tuple(ws.shape)}")
    b = xq.shape[0] if batched else 1
    if b < 1:
        raise ValueError("xq must have at least one row")
    if tuple(xs.shape) != ((b, ng) if batched else (ng,)):
        raise ValueError(f"xs must be {(b, ng) if batched else (ng,)}, got {tuple(xs.shape)}")
    for name, need in (("wq", align), ("xq", 16)):
        if named[name].data_ptr() % need:
            raise ValueError(f"{name} must be {need}-byte aligned for the kernel's loads")
    return b, m, n


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def gqmv_cuda(wq, ws, xq, xs, *, group_size: int, fmt: str = "int8") -> torch.Tensor:
    """out (m,) f32 = GQMV of the ``fmt`` weights wq (m, n logical) and xq (n,)."""
    _, m, n = _check(wq, ws, xq, xs, group_size, batched=False, fmt=fmt)
    out = torch.empty((m,), dtype=torch.float32, device=wq.device)
    stream = torch.cuda.current_stream(wq.device).cuda_stream
    name = f"gqmv_{fmt}"
    rc = getattr(_lib(), name)(wq.data_ptr(), ws.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                               out.data_ptr(), m, n, group_size, wq.device.index, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def gqmm_cuda(wq, ws, xq, xs, *, group_size: int, fmt: str = "int8") -> torch.Tensor:
    """out (b, m) f32 = GQMM of xq (b, n) against the ``fmt`` weights wq."""
    b, m, n = _check(wq, ws, xq, xs, group_size, batched=True, fmt=fmt)
    out = torch.empty((b, m), dtype=torch.float32, device=wq.device)
    stream = torch.cuda.current_stream(wq.device).cuda_stream
    name = f"gqmm_{fmt}"
    rc = getattr(_lib(), name)(wq.data_ptr(), ws.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                               out.data_ptr(), b, m, n, group_size, wq.device.index, stream)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
