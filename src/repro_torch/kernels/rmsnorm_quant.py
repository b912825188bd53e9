"""CUDA fused RMSNorm + int8 group quantization for Hopper: checked wrapper
and launch count.

Counterpart of ``repro/kernels/rmsnorm_quant.py``. The kernel is in
``csrc/rmsnorm_quant.cu`` (its design and bound are noted there):

  rmsnorm_quant_cuda  <- ``rmsnorm_quant_pallas`` (``_kernel``)

No model path calls it, in the reference or in the port: the reference's
model rounds the normed row back to the compute dtype before
``quantize_activation``, which the fused kernel skips at bf16, so it is a
standalone op held to its oracle (``kernels/ref.rmsnorm_quant_ref``).

Two designs, chosen by pointer and shape (:func:`design`, mirroring
``rows_ok`` in the CUDA source). The row design: a lane takes chunks of
``CHUNK`` consecutive elements of x and w as 16-byte loads, all issued
before it waits, a warp units of ``UNIT`` elements, a team of
:func:`plan`'s warps a row (``WARPS // team`` rows a CTA); the row stays in
registers; the sum of squares is each lane's chunks in order, an xor
butterfly over the warp's lanes and, after one barrier, a pairwise tree
over the team's 8 (or fewer, the rest +0) warp partials; each group's
absmax by shuffles among its lanes; 8-byte int8 stores. Rows off 16 bytes,
n no multiple of ``CHUNK`` and group sizes that are not a power of two from
``CHUNK`` to ``UNIT`` run the first design (a CTA a row, the row in shared
memory). Both keep the oracle's roundings; only the order of the sum of
squares differs from it (and between the two designs).

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything else; allocates the int8 values and f32
scales with ``torch.empty``; launches on the current stream; raises if the
launch reports a CUDA error; and adds one to ``LAUNCHES["rmsnorm_quant"]``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build

# dtype codes of csrc/rmsnorm_quant.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_N = 12288       # the first design's row lives in 48 KB of shared memory as f32
# csrc/rmsnorm_quant.cu: threads and warps a CTA; the row design's elements a
# lane takes at a time, a warp's unit, the chunks a lane holds at most, and
# the chunks a lane aims at (which set a row's team of warps)
THREADS = 256
WARPS = THREADS // 32
CHUNK = 8
UNIT = 32 * CHUNK
MAX_CHUNKS = MAX_N // (WARPS * UNIT)
TEAM_CHUNKS = 1


def design(n: int, group_size: int, aligned: bool = True) -> str:
    """The design that runs rows of n elements (``rows_ok``): "rows" when x
    and w are 16-byte ``aligned``, n a multiple of CHUNK and the group size
    a power of two from CHUNK to UNIT, else "first"."""
    gs = group_size
    ok = aligned and n % CHUNK == 0 and CHUNK <= gs <= UNIT and gs & (gs - 1) == 0
    return "rows" if ok else "first"


def first_smem_bytes(n: int) -> int:
    """Dynamic shared memory of a first-design CTA (``first_smem_bytes``):
    the row as f32."""
    return 4 * n


def plan(m: int, n: int) -> tuple[int, int, int, int]:
    """(warps a row, rows a CTA, CTAs, chunks a lane at most) of the row
    design: the fewest warps, at most WARPS, that leave a lane TEAM_CHUNKS
    chunks of the row's UNIT-element units."""
    units = -(-n // UNIT)
    team = 1
    while team < WARPS and team * TEAM_CHUNKS < units:
        team *= 2
    rows = WARPS // team
    return team, rows, -(-m // rows), -(-units // team)

# launches; a run zeroes this, drives the op, and reads it
LAUNCHES: dict[str, int] = {"rmsnorm_quant": 0}

_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = cuda_build.load("rmsnorm_quant")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rmsnorm_quant.argtypes = [p] * 4 + [i] * 3 + [f, i, i, i, p]
        lib.rmsnorm_quant.restype = i
        lib.rmsnorm_quant_empty.argtypes = [i, i, p]
        lib.rmsnorm_quant_empty.restype = i
        _LIB.append(lib)
    return _LIB[0]


def _check(x, w, *, group_size: int) -> tuple[int, int]:
    """Validates the kernel's arguments; returns (m, n)."""
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32, bfloat16 or float16, got {t.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")
    if x.ndim != 2:
        raise ValueError(f"x must be (m, n), got shape {tuple(x.shape)}")
    m, n = x.shape
    if tuple(w.shape) != (n,):
        raise ValueError(f"w must be ({n},), got {tuple(w.shape)}")
    if not 1 <= n <= MAX_N or m < 1 or m >= 2**31:
        raise ValueError(f"unsupported shape ({m}, {n}): 1 <= n <= {MAX_N}")
    if group_size < 1 or n % group_size:
        raise ValueError(f"group size {group_size} must divide n = {n}")
    return m, n


def rmsnorm_quant_cuda(x, w, *, group_size: int,
                       eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values (m, n), f32 scales (m, n / group_size)) of
    ``quantize_groupwise(rmsnorm(x in f32, w))``."""
    m, n = _check(x, w, group_size=group_size)
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, n // group_size), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().rmsnorm_quant(x.data_ptr(), w.data_ptr(), q.data_ptr(), scales.data_ptr(),
                              m, n, group_size, float(eps), _DTYPES[x.dtype], _DTYPES[w.dtype],
                              x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_quant kernel launch failed with CUDA error {rc}")
    LAUNCHES["rmsnorm_quant"] += 1
    return q, scales


def empty_cuda(ctas: int, device: torch.device) -> None:
    """Launch an empty kernel of ``ctas`` CTAs of THREADS threads on the
    current stream: the card's floor for a launch like the row design's,
    timed beside it. Counts no launch of the op."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _lib().rmsnorm_quant_empty(int(ctas), device.index, stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed with CUDA error {rc}")
