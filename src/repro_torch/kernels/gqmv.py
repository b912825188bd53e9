"""CUDA GQMV/GQMM kernels for Hopper: checked wrappers and launch counts.

Counterpart of ``repro/kernels/gqmv.py``. The kernels themselves are in
``csrc/gqmm.cu`` (their design and bound are noted there):

  gqmv_cuda  <- ``gqmv_pallas`` (paper Alg. 1, batch-1 matrix-vector)
  gqmm_cuda  <- ``gqmm_pallas`` (batched: prefill b = tokens, decode b = batch)

Each wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and 16-byte alignment and raises on anything else, allocates
the f32 output with ``torch.empty``, launches on the current stream, raises
if the launch reports a CUDA error, and adds one to ``LAUNCHES`` for every
launch. The plain versions are ``kernels/ref.py``; ``kernels/ops.py``
chooses between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build

GROUP_SIZES = (16, 32, 64, 128, 256)

# launches per kernel; a run zeroes these, drives the model, and reads them
LAUNCHES: dict[str, int] = {"gqmv_int8": 0, "gqmm_int8": 0}

_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = cuda_build.load("gqmm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gqmv_int8.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.gqmv_int8.restype = i
        lib.gqmm_int8.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.gqmm_int8.restype = i
        _LIB.append(lib)
    return _LIB[0]


def _check(wq, ws, xq, xs, group_size: int, batched: bool) -> tuple[int, int, int]:
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
    for name, want in (("wq", torch.int8), ("ws", torch.float32),
                       ("xq", torch.int8), ("xs", torch.float32)):
        if named[name].dtype != want:
            raise TypeError(f"{name} must be {want}, got {named[name].dtype}")
    if wq.ndim != 2:
        raise ValueError(f"wq must be (m, n), got shape {tuple(wq.shape)}")
    m, n = wq.shape
    if group_size not in GROUP_SIZES or n % group_size:
        raise ValueError(f"group_size {group_size} must be one of {GROUP_SIZES} "
                         f"and divide n={n}")
    ng = n // group_size
    if tuple(ws.shape) != (m, ng):
        raise ValueError(f"ws must be {(m, ng)}, got {tuple(ws.shape)}")
    if batched:
        if xq.ndim != 2 or xq.shape[1] != n or xq.shape[0] < 1:
            raise ValueError(f"xq must be (b, {n}) with b >= 1, got {tuple(xq.shape)}")
        b = xq.shape[0]
        if tuple(xs.shape) != (b, ng):
            raise ValueError(f"xs must be {(b, ng)}, got {tuple(xs.shape)}")
    else:
        if tuple(xq.shape) != (n,):
            raise ValueError(f"xq must be ({n},), got {tuple(xq.shape)}")
        if tuple(xs.shape) != (ng,):
            raise ValueError(f"xs must be ({ng},), got {tuple(xs.shape)}")
        b = 1
    if m < 1:
        raise ValueError("wq must have at least one row")
    for name in ("wq", "xq"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's vector loads")
    return b, m, n


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def gqmv_cuda(wq, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """out (m,) f32 = W8A8 GQMV of wq (m, n) and xq (n,)."""
    _, m, n = _check(wq, ws, xq, xs, group_size, batched=False)
    out = torch.empty((m,), dtype=torch.float32, device=wq.device)
    stream = torch.cuda.current_stream(wq.device).cuda_stream
    rc = _lib().gqmv_int8(wq.data_ptr(), ws.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                          out.data_ptr(), m, n, group_size, wq.device.index, stream)
    _raise_on(rc, "gqmv_int8")
    LAUNCHES["gqmv_int8"] += 1
    return out


def gqmm_cuda(wq, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """out (b, m) f32 = W8A8 GQMM of xq (b, n) against wq (m, n)."""
    b, m, n = _check(wq, ws, xq, xs, group_size, batched=True)
    out = torch.empty((b, m), dtype=torch.float32, device=wq.device)
    stream = torch.cuda.current_stream(wq.device).cuda_stream
    rc = _lib().gqmm_int8(wq.data_ptr(), ws.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                          out.data_ptr(), b, m, n, group_size, wq.device.index, stream)
    _raise_on(rc, "gqmm_int8")
    LAUNCHES["gqmm_int8"] += 1
    return out
