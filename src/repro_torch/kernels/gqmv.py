"""CUDA GQMV/GQMM kernels for Hopper: checked wrappers and launch counts.

Counterpart of ``repro/kernels/gqmv.py``. The kernels themselves are in
``csrc/gqmm.cu`` (their design and bound are noted there), one pair per
weight format:

  gqmv_cuda(fmt=...)  <- ``gqmv_pallas`` / ``gqmv_{int4,int3,fp8}_pallas``
                         (paper Alg. 1, batch-1 matrix-vector)
  gqmm_cuda(fmt=...)  <- ``gqmm_pallas`` / ``gqmm_{int4,int3,fp8}_pallas``
                         (batched: prefill b = tokens, decode b = batch)

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

GROUP_SIZES = (16, 32, 64, 128, 256)

# weight format -> the byte alignment of the 16-weight row chunk a lane
# loads (16 bytes of int8 or fp8, 8 of int4, 6 of int3 as 16-bit words)
WEIGHT_FORMATS: dict[str, int] = {"int8": 16, "int4": 8, "int3": 2, "fp8": 16}

# launches per kernel; a run zeroes these, drives the model, and reads them
LAUNCHES: dict[str, int] = {f"{kind}_{fmt}": 0 for fmt in WEIGHT_FORMATS
                            for kind in ("gqmv", "gqmm")}

_LIB: list[ctypes.CDLL] = []


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
