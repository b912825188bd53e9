"""CUDA flash-attention kernel for Hopper: checked wrapper and launch count.

Counterpart of ``repro/kernels/flash_attn.py``. The kernel is in
``csrc/flash_attn.cu`` (its design and bound are noted there):

  flash_attention_cuda  <- ``flash_attention_pallas`` (``_flash_kernel``):
                           causal / windowed / soft-capped GQA attention
                           with an online softmax, f32 inside; bf16 and
                           fp16 inputs run on the tensor cores
                           (``mma.sync``), f32 inputs on the CUDA cores;
                           optionally also each row's f32 log-sum-exp
  flash_attention_bwd_cuda  dQ, dK, dV of that function (no Pallas
                           counterpart: the reference differentiates
                           ``_mha_blockwise`` with XLA): FlashAttention-2's
                           recomputation from the log-sum-exp, bf16 and
                           fp16 on the tensor cores, f32 register-tiled on
                           the CUDA cores, deterministic (no atomics)

The f32 kernel is register-tiled: a CTA of 8 warps owns 64 query rows,
a lane holds a 4 x 4 micro-tile of S (4 rows x 4 keys, over a d-split of
the head dim where the K/V tile is narrower than 64 keys) and 4 rows x the
16-byte dim-chunks of O it owns; K/V tiles of :func:`f32_keys` keys are
staged by 16-byte ``cp.async`` into rows of :func:`f32_row_floats` floats,
and P passes once through shared memory. :func:`f32_smem_bytes` mirrors
its shared memory (two CTAs fit an SM at every head dim);
:func:`f32_layout` asks the card for it and for the CTAs an SM holds.

The backward's two products kernels (dK/dV: a CTA per query head and key
tile; dQ: a CTA per query head and query tile) keep :func:`bwd_rows` rows
and stream tiles of ``BWD_COLS`` columns (the f32 kernels: 64 rows and
:func:`f32_keys` columns); :func:`bwd_smem_bytes` mirrors their shared
memory, :func:`bwd_workspace_bytes` the f32 partials of dK and dV that GQA
sums in head order, and :func:`bwd_layout` asks the card.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity (the kernel reads q (b*H, s, hd) and k/v (b*KV, t, hd) rows as
dense arrays; a permuted view of the model's (b, s, H, hd) projection would
be read wrongly, so the caller makes them contiguous) and raises on
anything else; allocates the output with ``torch.empty``; launches on the
current stream; raises if the launch reports a CUDA error; and adds one to
``LAUNCHES`` under the kernel the dtype chose: ``flash_attn`` (bf16 / fp16,
tensor cores) or ``flash_attn_f32`` (f32, CUDA cores), and ``flash_attn_bwd``
for a backward (its launches: D = rowsum(dO * O), dK/dV, dQ, and for GQA
the group sum). The plain versions are ``kernels/ref.flash_attention_ref``
and ``flash_attention_bwd_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import MAX_SMEM  # noqa: F401  (the kernels' opt-in)

# dtype codes of csrc/flash_attn.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# head dims both kernels are built for: TinyLlama's 64, 128 (internlm2,
# deepseek-coder, pixtral, dbrx), gemma2's 256, zamba2's shared attention's
# 112 and the reduced configs' 32
HEAD_DIMS = (32, 64, 112, 128, 256)


def kv_tile(hd: int) -> int:
    """Keys a K/V tile of the tensor-core kernel (``kv_tile`` in
    ``csrc/flash_attn.cu``): 64, or 32 at hd 256, where the output's
    accumulators take 128 registers a lane."""
    return 32 if hd > 128 else 64

# csrc/flash_attn.cu, the f32 kernel: threads a CTA, query rows a CTA,
# lanes of a row group (which holds rows ty, ty + 16, ty + 32, ty + 48)
F32_THREADS, F32_BQ, F32_LANES, F32_ROWS = 256, 64, 16, 4


def f32_keys(hd: int) -> int:
    """Keys a K/V tile of the f32 kernel (``f32_keys``): 64, 32 at hd 128,
    16 at hd 256, where Q's 64 staged rows take most of the room."""
    return 64 if hd <= 112 else 32 if hd <= 128 else 16


def f32_splits(hd: int) -> int:
    """d-splits of S (``f32_splits``): a row group's 16 lanes are
    ``f32_keys(hd) / 4`` key groups x this many splits of the head dim."""
    return F32_LANES * 4 // f32_keys(hd)


def f32_row_floats(hd: int) -> int:
    """Floats between staged rows (``f32_row_floats``): the head dim and a
    pad that makes the stride in 16-byte chunks odd (one split), 3 mod 8
    (two) or 4 mod 8 (four)."""
    return hd + {1: 4, 2: 12, 4: 16}[f32_splits(hd)]


def f32_smem_bytes(hd: int) -> int:
    """The f32 kernel's dynamic shared memory (``f32_smem_bytes``): Q's 64
    rows, one K and one V tile, and P (64 rows of keys + 4 floats)."""
    row, keys = f32_row_floats(hd), f32_keys(hd)
    return 4 * (F32_BQ * row + 2 * keys * row + F32_BQ * (keys + 4))


def f32_layout(hd: int, device: int = 0) -> tuple[int, int]:
    """(shared-memory bytes, CTAs an SM holds) of the compiled f32 kernel at
    head dim ``hd``, from the card (``flash_attn_f32_layout``)."""
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    rc = _lib().flash_attn_f32_layout(int(hd), int(device), ctypes.byref(smem),
                                      ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"flash_attn_f32_layout failed with CUDA error {rc}")
    return smem.value, ctas.value


# csrc/flash_attn.cu, the tensor-core forward: query rows a CTA and stages
# of the K/V ring
MMA_BQ, MMA_STAGES = 64, 2

# csrc/flash_attn.cu, the backward: threads of a tensor-core CTA (4 warps,
# 16 rows a warp) and columns a streamed tile (kBwdCols)
BWD_THREADS, BWD_COLS = 128, 32


def bwd_dsplit(hd: int, dq: bool) -> int:
    """Warps that share 16 rows and split the head dim of the tensor-core
    dK/dV kernel's accumulators (``bwd_dsplit``): 2 at hd 256, else 1."""
    return 2 if not dq and hd > 128 else 1


def bwd_rows(hd: int, dq: bool) -> int:
    """Rows (keys for dK/dV, query positions for dQ) a tensor-core CTA keeps
    (``bwd_rows``): 16 a warp over the d-splits."""
    return 16 * (BWD_THREADS // 32) // bwd_dsplit(hd, dq)


def row_elems(hd: int) -> int:
    """Elements a staged bf16 / fp16 row takes (``row_elems``): hd, or hd 112
    padded to 128 for the swizzle."""
    return hd if hd < 64 or hd % 64 == 0 else -(-hd // 64) * 64


def mma_smem_bytes(hd: int) -> int:
    """The tensor-core forward kernel's dynamic shared memory
    (``mma_smem_bytes``): Q's 64 rows and two ring stages of a K and a V
    tile (:func:`kv_tile` keys), 2-byte elements of :func:`row_elems`."""
    return 2 * (MMA_BQ * row_elems(hd) + 2 * MMA_STAGES * kv_tile(hd) * row_elems(hd))


def bwd_smem_bytes(hd: int, dq: bool, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of a backward products kernel
    (``bwd_mma_smem_bytes`` / ``bwd_f32_smem_bytes``): the kept rows' two
    tiles, the streamed column tiles (two ring stages of two for bf16 /
    fp16, one of each for f32), P and dS (f32), and for dK/dV the columns'
    lse and D."""
    if dtype == torch.float32:
        row, cols = f32_row_floats(hd), f32_keys(hd)
        return 4 * (2 * F32_BQ * row + 2 * cols * row + (1 if dq else 2) * F32_BQ * (cols + 4)
                    + (0 if dq else 2 * cols))
    rows, cols, row = bwd_rows(hd, dq), BWD_COLS, row_elems(hd)
    return 2 * (2 * rows * row + 2 * 2 * cols * row) + (0 if dq else 4 * 2 * 2 * cols)


def bwd_workspace_bytes(bh: int, t: int, hd: int, group: int) -> int:
    """The f32 partials of dK and dV that the wrapper allocates for GQA
    (group > 1): one (b*H, t, hd) each; none for group 1."""
    return 0 if group == 1 else 2 * bh * t * hd * 4


def bwd_layout(hd: int, dtype: torch.dtype, dq: bool, device: int = 0) -> tuple[int, int]:
    """(shared-memory bytes, CTAs an SM holds) of the compiled backward
    products kernel (``flash_attn_bwd_layout``) for ``dtype`` at head dim
    ``hd``: the dQ kernel if ``dq``, else dK/dV."""
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    rc = _lib().flash_attn_bwd_layout(int(hd), _DTYPES[dtype], int(bool(dq)), int(device),
                                      ctypes.byref(smem), ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_layout failed with CUDA error {rc}")
    return smem.value, ctas.value


# launches by kernel: the tensor-core kernel (bf16 / fp16), the CUDA-core
# kernel (f32) and the backward (one a call, every dtype); a run zeroes
# these, drives the model, and reads them
LAUNCHES: dict[str, int] = {"flash_attn": 0, "flash_attn_f32": 0, "flash_attn_bwd": 0}

_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = cuda_build.load("flash_attn")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn.argtypes = [p] * 5 + [i] * 6 + [f, i, i, f, i, i, p]
        lib.flash_attn.restype = i
        lib.flash_attn_bwd.argtypes = [p] * 12 + [i] * 6 + [f, i, i, f, i, i, p]
        lib.flash_attn_bwd.restype = i
        lib.flash_attn_f32_layout.argtypes = [i, i, p, p]
        lib.flash_attn_f32_layout.restype = i
        lib.flash_attn_bwd_layout.argtypes = [i, i, i, i, p, p]
        lib.flash_attn_bwd_layout.restype = i
        _LIB.append(lib)
    return _LIB[0]


def _check(q, k, v, *, group: int, window) -> tuple[int, int, int, int, int]:
    """Validates the kernel's arguments; returns (b*H, b*KV, s, t, hd)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got device {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (stride {x.stride()}, shape "
                             f"{tuple(x.shape)})")
        if x.ndim != 3:
            raise ValueError(f"{name} must be 3-D, got shape {tuple(x.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32, bfloat16 or float16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {x.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    bh, s, hd = q.shape
    bkv, t, hdk = k.shape
    if hd not in HEAD_DIMS or hdk != hd:
        raise ValueError(f"head dims must match and be one of {HEAD_DIMS}, got q {hd}, k {hdk}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v must be {tuple(k.shape)} like k, got {tuple(v.shape)}")
    if group < 1 or bkv * group != bh:
        raise ValueError(f"q rows ({bh}) must be k rows ({bkv}) x group ({group})")
    if not 1 <= bh <= 65535 or s < 1 or t < 1:
        raise ValueError(f"unsupported shape: b*H={bh} (1..65535), s={s}, t={t}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.dtype != torch.float32:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the tensor-core "
                                 "kernel's 16-byte copies")
    return bh, bkv, s, t, hd


def flash_attention_cuda(q, k, v, *, group: int, scale: float, causal: bool = True,
                         window: int | None = None, softcap: float | None = None,
                         return_lse: bool = False):
    """out (b*H, s, hd) in q's dtype (see ``kernels/ref.flash_attention_ref``
    for the math); with ``return_lse`` (out, lse), lse the f32 (b*H, s)
    log-sum-exp of each row's scores, which the same launch writes (without
    it the kernel is given no pointer and writes none)."""
    bh, bkv, s, t, hd = _check(q, k, v, group=group, window=window)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, bh, bkv, s, t, hd, group,
        float(scale), int(bool(causal)), int(window or 0), float(softcap or 0.0),
        _DTYPES[q.dtype], q.device.index, stream)
    name = kernel_name(q.dtype)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, group: int, scale: float,
                             causal: bool = True, window: int | None = None,
                             softcap: float | None = None):
    """(dq, dk, dv) in the inputs' dtype: the gradient of
    :func:`flash_attention_cuda`'s output ``out`` times ``dout``, from its
    ``lse`` (see ``kernels/ref.flash_attention_bwd_ref`` for the math). dk
    and dv sum over each KV row's group of query rows (for group > 1 through
    f32 partials of :func:`bwd_workspace_bytes`, added in head order).
    Refuses a window with more query positions than keys (rows that see no
    key, whose forward weights are not a softmax of visible scores)."""
    bh, bkv, s, t, hd = _check(q, k, v, group=group, window=window)
    for name, x in (("out", out), ("dout", dout)):
        if (not isinstance(x, torch.Tensor) or x.device != q.device or x.dtype != q.dtype
                or tuple(x.shape) != tuple(q.shape) or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor of shape "
                             f"{tuple(q.shape)} on {q.device}")
    if (not isinstance(lse, torch.Tensor) or lse.device != q.device
            or lse.dtype != torch.float32 or tuple(lse.shape) != (bh, s)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 tensor of shape {(bh, s)} on "
                         f"{q.device}")
    if window is not None and s > t:
        raise ValueError(f"a window with s ({s}) > t ({t}) leaves rows with no visible key")
    if q.dtype != torch.float32 and dout.data_ptr() % 16:
        dout = dout.clone()         # the tensor-core kernels copy 16-byte chunks
    delta = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = (torch.empty((2, bh, t, hd), dtype=torch.float32, device=q.device)
            if group > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if part is None else part[0].data_ptr(),
        None if part is None else part[1].data_ptr(),
        bh, bkv, s, t, hd, group, float(scale), int(bool(causal)), int(window or 0),
        float(softcap or 0.0), _DTYPES[q.dtype], q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed with CUDA error {rc}")
    LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv


def kernel_name(dtype: torch.dtype) -> str:
    """The ``LAUNCHES`` key of the kernel that inputs of ``dtype`` run."""
    return "flash_attn_f32" if dtype == torch.float32 else "flash_attn"
