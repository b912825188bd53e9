"""CUDA paged decode-attention kernel for Hopper: checked wrapper and launch counts.

Counterpart of ``repro/kernels/paged_attn.py``. The kernel is in
``csrc/paged_attn.cu`` (its design and bound are noted there):

  paged_attention_cuda  <- ``paged_attention_pallas``: float pools
                           (``_paged_kernel``) and int8/fp8 pools with
                           per-row f32 scales (``_paged_quant_kernel``)

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and the alignment of the pool's 16-byte copies and raises on
anything else; converts the block table and positions to int32 explicitly
(the port's positions are ``long``); picks the split plan from the shapes
alone (:func:`split_plan`: no host sync); allocates the output, and for
more than one split the f32 scratch of the partial sums, with
``torch.empty``; launches on the current stream (the split pass, then the
combine when there is more than one split, in one C call); raises if a
launch reports a CUDA error; and counts one launch of the op in
``LAUNCHES`` under ``paged_attn`` (float pool) or ``paged_attn_quant``
(int8/fp8 pool).

One property of the kernel the caller relies on: a pool block whose mask
entries are all <= -1e29 is skipped, neither read nor summed. That is exact
whenever every row has an unmasked column, as every decode mask has
(``models/common.decode_mask``: column ``pos`` is always open), so pass
decode masks. The plain version is ``kernels/ref.paged_attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import MAX_SMEM

# dtype codes of csrc/paged_attn.cu
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}

# csrc/paged_attn.cu: threads a CTA, columns a tile (whole blocks; half as
# many where a staged row is wider than WIDE_ROW bytes), output elements a
# thread, tiles of K/V rows in the ring, tiles of mask / table entries, the
# head dims it is built for
THREADS, TILE_COLS, WIDE_ROW, MAX_OUT = 256, 64, 512, 4
STAGES, SLOTS = 3, 5
HEAD_DIMS = (32, 64, 128, 256)
# split-K aims at this many CTAs: eight for each of the H100's 132 SMs; at
# most MAX_SPLITS splits a row (the combine stages every split's m and l);
# two tiles a split or more once a row has PAIR_FROM tiles
SMS, CTAS_PER_SM, MAX_SPLITS, PAIR_FROM = 132, 8, 64, 8

# launches per pool kind; a run zeroes these, drives the model, and reads them
LAUNCHES: dict[str, int] = {"paged_attn": 0, "paged_attn_quant": 0}

_LIB: list[ctypes.CDLL] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = cuda_build.load("paged_attn")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attn.argtypes = [p] * 12 + [i] * 9 + [f, f, i, i, i, p]
        lib.paged_attn.restype = i
        _LIB.append(lib)
    return _LIB[0]


def tile_cols(hd: int, elt: int) -> int:
    """Columns a tile for rows of ``hd`` values of ``elt`` bytes: 64, or 32
    where a row is wider than 512 bytes (an f32 pool at hd 256), so that
    three stages of K and V rows fit in shared memory."""
    return TILE_COLS // 2 if hd * elt > WIDE_ROW else TILE_COLS


def tile_blocks(bs: int, cols: int = TILE_COLS) -> int:
    """Blocks a tile: whole blocks filling ``cols`` columns (one if larger)."""
    return 1 if bs >= cols else cols // bs


def smem_bytes(g: int, hd: int, bs: int, elt: int, quant: bool) -> int:
    """Dynamic shared memory of one split-pass CTA, as ``csrc/paged_attn.cu``
    sizes it: ``STAGES`` stages of K and V rows (``elt`` bytes an element)
    and, for a quantized pool, their f32 scales; then q, k_new, v_new, the
    scores, alpha / l / m, ``SLOTS`` slots of mask values and table entries,
    and ``STAGES`` stages of row offsets."""
    tb = tile_blocks(bs, tile_cols(hd, elt))
    tc = tb * bs
    return (2 * STAGES * tc * hd * elt + (2 * STAGES * tc * 4 if quant else 0)
            + 4 * (g * hd + 2 * hd + g * tc + 3 * g) + 4 * (SLOTS * (tc + tb) + STAGES * tc))


def combine_smem_bytes(g: int, nsplit: int) -> int:
    """Dynamic shared memory of one combine CTA (``combine_smem_bytes``): m
    (then the weights) and l of every split and head, and each head's
    denominator."""
    return 4 * (2 * nsplit * g + g)


def split_plan(b: int, kv: int, mb: int, bs: int, cols: int = TILE_COLS) -> tuple[int, int]:
    """(S, tiles per split) from the shapes alone: enough splits of a row's
    tiles that the grid (KV, b, S) has about ``CTAS_PER_SM`` CTAs for each
    SM, at most ``MAX_SPLITS`` a row, every split non-empty, and at least
    two tiles a split once a row has ``PAIR_FROM`` tiles (a split's first
    tile waits for two memory round trips, the mask and table entries and
    then the rows; a second tile's loads hide behind the first one's sums).
    Never reads positions or the mask, so choosing it needs no host sync.
    ``cols`` is the tile's width (:func:`tile_cols` of the pool's rows)."""
    ntiles = -(-mb // tile_blocks(bs, cols))
    want = -(-SMS * CTAS_PER_SM // (b * kv))
    most = ntiles // 2 if ntiles >= PAIR_FROM else ntiles
    tps = -(-ntiles // max(1, min(most, want, MAX_SPLITS)))
    return -(-ntiles // tps), tps


def _check(q, k_pages, v_pages, block_table, pos, k_new, v_new, mask, k_scales, v_scales):
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages, "block_table": block_table,
             "pos": pos, "k_new": k_new, "v_new": v_new, "mask": mask}
    if (k_scales is None) != (v_scales is None):
        raise ValueError("a quantized pool needs both k_scales and v_scales")
    quant = k_scales is not None
    if quant:
        named.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for t in named.values()}) != 1:
        raise ValueError("all tensors must be on one device")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name in ("k_new", "v_new"):
        if named[name].dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype} like q, got {named[name].dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"v_pages must be {k_pages.dtype} like k_pages, got {v_pages.dtype}")
    if quant:
        if k_pages.dtype not in _QUANT_DTYPES:
            raise TypeError(f"a pool with scales must be int8 or float8_e4m3fn, "
                            f"got {k_pages.dtype}")
        for name in ("k_scales", "v_scales"):
            if named[name].dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {named[name].dtype}")
    elif k_pages.dtype != q.dtype:
        raise TypeError(f"a float pool must be {q.dtype} like q, got {k_pages.dtype} "
                        "(int8/fp8 pools need k_scales and v_scales)")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    for name in ("block_table", "pos"):
        if named[name].dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {named[name].dtype}")
    if q.ndim != 4:
        raise ValueError(f"q must be (b, KV, G, hd), got shape {tuple(q.shape)}")
    b, kv, g, hd = q.shape
    if k_pages.ndim != 4 or k_pages.shape[2:] != (kv, hd):
        raise ValueError(f"k_pages must be (NB, BS, {kv}, {hd}), got {tuple(k_pages.shape)}")
    nb, bs = k_pages.shape[:2]
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"v_pages must be {tuple(k_pages.shape)}, got {tuple(v_pages.shape)}")
    if quant:
        for name in ("k_scales", "v_scales"):
            if tuple(named[name].shape) != (nb, bs, kv):
                raise ValueError(f"{name} must be {(nb, bs, kv)}, "
                                 f"got {tuple(named[name].shape)}")
    if block_table.ndim != 2 or block_table.shape[0] != b or block_table.shape[1] < 1:
        raise ValueError(f"block_table must be ({b}, MB) with MB >= 1, "
                         f"got {tuple(block_table.shape)}")
    mb = block_table.shape[1]
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    for name in ("k_new", "v_new"):
        if tuple(named[name].shape) != (b, kv, hd):
            raise ValueError(f"{name} must be {(b, kv, hd)}, got {tuple(named[name].shape)}")
    if tuple(mask.shape) != (b, mb * bs):
        raise ValueError(f"mask must be {(b, mb * bs)}, got {tuple(mask.shape)}")
    if not 1 <= b <= 65535 or hd not in HEAD_DIMS or g * hd > MAX_OUT * THREADS:
        raise ValueError(f"unsupported shape b={b}, G={g}, hd={hd}: the kernel takes "
                         f"1 <= b <= 65535, hd in {HEAD_DIMS} and G * hd <= "
                         f"{MAX_OUT * THREADS}")
    need = smem_bytes(g, hd, bs, k_pages.element_size(), quant)
    if need > MAX_SMEM:
        raise ValueError(f"block size {bs} with G={g}, hd={hd} needs {need} bytes of "
                         f"shared memory (max {MAX_SMEM})")
    for name in ("k_pages", "v_pages"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the kernel's 16-byte "
                             "copies")
    return b, kv, g, hd, bs, mb, nb, quant


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def paged_attention_cuda(q, k_pages, v_pages, block_table, pos, k_new, v_new, mask, *,
                         scale: float, softcap: float | None = None,
                         k_scales=None, v_scales=None) -> torch.Tensor:
    """ctx (b, KV * G * hd) in q's dtype: one decode step of attention over
    the block pool (see ``kernels/ref.paged_attention_ref`` for the math)."""
    b, kv, g, hd, bs, mb, nb, quant = _check(q, k_pages, v_pages, block_table, pos,
                                             k_new, v_new, mask, k_scales, v_scales)
    table32 = block_table.to(torch.int32)       # explicit: the kernel reads int32
    pos32 = pos.to(torch.int32)
    out = torch.empty((b, kv * g * hd), dtype=q.dtype, device=q.device)
    nsplit, tps = split_plan(b, kv, mb, bs, tile_cols(hd, k_pages.element_size()))
    part = (torch.empty((b, kv, nsplit, g, hd + 2), dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    pool_code = _QUANT_DTYPES[k_pages.dtype] if quant else _Q_DTYPES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().paged_attn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        table32.data_ptr(), pos32.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        mask.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
        b, kv, g, hd, bs, mb, nb, nsplit, tps,
        float(scale), float(softcap or 0.0), _Q_DTYPES[q.dtype], pool_code,
        q.device.index, stream)
    name = "paged_attn_quant" if quant else "paged_attn"
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
