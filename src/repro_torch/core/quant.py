"""Group-wise quantization formats (counterpart of ``repro/core/quant.py``).

The paper's symmetric group-wise PTQ with per-group f32 scales (Eq. 1/2):

  Q(r)  = Int(r / S),            S = 2 * max(|r|) / (2^b - 1)
  r_hat = Q(r) * S

with the last (contraction) axis split into groups of ``GS`` elements. The
formats are entries of a registry, as in the reference:

  int8   storage int8, 1 value per byte, range [-127, 127] (the paper)
  int4   storage int8, 2 nibbles per byte, range [-7, 7]; the low nibble
         holds the even element
  int3   storage uint8, 8 values per 3 bytes (one little-endian 24-bit
         word, element i in bits [3i, 3i+3)), range [-3, 3]
  fp8    storage float8_e4m3fn, 1 value per byte, S = max|r| / 448

The arithmetic is bit-exact against the reference: absmax and the scale
constant in f32, a true division, round half to even, clip to +-qmax (the
all-zero group keeps scale 0 and values 0); fp8 rounds to nearest even in
the storage cast. Activations are always quantized to int8 (W4A8, W3A8 and
fp8-weight x int8-activation products).

The repro-san numerics tripwires (``set_numerics_checks``, armed by the
sanitizer, ``analysis/sanitizer.py``) guard the format-dispatched
``quantize`` and ``dequantize`` entry points: the input, the scales and
the output. They run where the reference's run, on concrete values (PTQ
at engine init, direct calls): the model step's own dequantize
(``dequantize_unchecked``) and anything run while a CUDA graph is being
captured pass unchecked, as the reference's guards pass its tracers.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from functools import reduce
from typing import Callable

import torch

DEFAULT_GROUP_SIZE = 256  # paper §III-A: GS=256 divides every TinyLlama dim

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


# ---------------------------------------------------------------------------
# repro-san numerics tripwires (off unless the sanitizer arms them)
# ---------------------------------------------------------------------------

_OVERFLOW_LIMIT = 1e30          # |x| beyond this at a boundary is an error
_NUMERICS = {"on": False}       # process-global, like the format registry
# elements a guard reads at once: a stacked leaf of billions of weights is
# checked a slice at a time, so the check adds no leaf-sized temporary
_GUARD_CHUNK = 1 << 24


class QuantNumericsError(ArithmeticError):
    """NaN/Inf/overflow crossing a quantize/dequantize boundary."""


def set_numerics_checks(on: bool) -> None:
    _NUMERICS["on"] = bool(on)


def numerics_checks_enabled() -> bool:
    return _NUMERICS["on"]


@contextmanager
def numerics_checks(on: bool = True):
    """Scoped enable/disable for tests and one-off audits."""
    prev = _NUMERICS["on"]
    _NUMERICS["on"] = bool(on)
    try:
        yield
    finally:
        _NUMERICS["on"] = prev


def _numerics_guard(tag: str, x: torch.Tensor) -> None:
    """Raise :class:`QuantNumericsError` if ``x`` holds a NaN, an Inf or a
    value past ``_OVERFLOW_LIMIT``, naming the count and the first one
    (the reference's message). Integer tensors, and any tensor while a
    CUDA graph is being captured (a device read there ends the capture),
    pass."""
    if not x.is_floating_point() or (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        return
    flat = x.detach().reshape(-1)
    n, first = 0, None
    for i in range(0, flat.numel(), _GUARD_CHUNK):
        part = flat[i:i + _GUARD_CHUNK].float()
        bad = ~(part.abs() <= _OVERFLOW_LIMIT)          # NaN compares False
        k = int(bad.sum())
        if k and first is None:
            first = i + int(bad.nonzero()[0, 0])
        n += k
    if n:
        idx = tuple(int(v) for v in torch.unravel_index(torch.tensor(first), tuple(x.shape)))
        val = flat[first].float().cpu().numpy()[()]
        raise QuantNumericsError(
            f"repro-san[numerics]: {tag}: {n} non-finite/overflow value(s) "
            f"of {x.numel()}, first at index {idx} = {val!r}")


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A group-wise symmetric quantized tensor in some registered format.

    ``qvalues`` is the storage array: the logical shape for unpacked
    formats, the last axis times ``pack_storage / pack`` for packed ones.
    ``scales`` is f32 with the logical last axis reduced by ``group_size``.
    Groups run along the last axis, the contraction axis of the matmul that
    consumes it.
    """

    qvalues: torch.Tensor  # storage dtype, shape (..., n // pack * pack_storage)
    scales: torch.Tensor   # float32, shape (..., n // group_size)
    group_size: int
    fmt: str = "int8"

    @property
    def format(self) -> "QuantFormat":
        return get_format(self.fmt)

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical shape: what ``dequantize()`` returns. Model code that reads
        dims off a weight (the fused SwiGLU split) must see the represented
        tensor, not the byte layout."""
        return self.logical_shape

    @property
    def storage_shape(self) -> tuple[int, ...]:
        return tuple(self.qvalues.shape)

    @property
    def logical_shape(self) -> tuple[int, ...]:
        s = self.qvalues.shape
        f = self.format
        return (*s[:-1], s[-1] * f.pack // f.pack_storage)

    @property
    def num_groups(self) -> int:
        return self.scales.shape[-1]

    def __getitem__(self, i) -> "QuantizedTensor":
        """Slice the leading axes (e.g. one layer of a stacked (L, m, n) leaf)."""
        return QuantizedTensor(self.qvalues[i], self.scales[i], self.group_size, self.fmt)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.qvalues.to(device), self.scales.to(device),
                               self.group_size, self.fmt)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype=dtype)

    def nbytes(self) -> int:
        return (self.qvalues.numel() * self.qvalues.element_size()
                + self.scales.numel() * self.scales.element_size())

    def storage_bits(self) -> int:
        return 8 * self.nbytes()


# ---------------------------------------------------------------------------
# format registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantFormat:
    """Spec for one quantization format.

    ``kernel`` names the format's GQMV/GQMM pair in ``kernels/ops.py``
    (``KERNEL_HOOKS``). ``pack`` logical elements occupy ``pack_storage``
    storage elements (int4: 2/1, int3: 8/3); ``unpack_fn`` turns storage
    into logical values (int8 for the integer formats). Every format
    dequantizes the same way, r_hat = unpacked value * S (Eq. 2).
    """

    name: str
    bits: int
    storage_dtype: torch.dtype
    pack: int
    qmax: int
    kernel: str
    quantize_fn: Callable = dataclasses.field(repr=False, default=None)
    unpack_fn: Callable | None = dataclasses.field(repr=False, default=None)
    pack_storage: int = 1

    def quantize(self, r: torch.Tensor, group_size: int) -> QuantizedTensor:
        if _NUMERICS["on"]:
            _numerics_guard(f"quantize[{self.name}].input", r)
        qt = self.quantize_fn(r, group_size=group_size)
        if _NUMERICS["on"]:
            _numerics_guard(f"quantize[{self.name}].scales", qt.scales)
        return qt

    def unpack_values(self, qvalues: torch.Tensor) -> torch.Tensor:
        """Storage -> logical values (identity when unpacked)."""
        return qvalues if self.unpack_fn is None else self.unpack_fn(qvalues)


_FORMATS: dict[str, QuantFormat] = {}


def register_format(fmt: QuantFormat) -> QuantFormat:
    if fmt.name in _FORMATS:
        raise ValueError(f"quant format {fmt.name!r} already registered")
    _FORMATS[fmt.name] = fmt
    return fmt


def get_format(name: str) -> QuantFormat:
    try:
        return _FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown quant format {name!r}; registered: "
                         f"{available_formats()}") from None


def available_formats() -> tuple[str, ...]:
    return tuple(sorted(_FORMATS))


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _check_group_size(n: int, group_size: int) -> None:
    if n % group_size != 0:
        raise ValueError(
            f"last axis ({n}) must be divisible by group_size ({group_size}); "
            "pick GS per paper §III-A (GS must divide every quantized dim)")


def _groups(r: torch.Tensor, group_size: int) -> torch.Tensor:
    n = r.shape[-1]
    _check_group_size(n, group_size)
    return r.reshape(*r.shape[:-1], n // group_size, group_size).to(torch.float32)


def _group_quantize(r: torch.Tensor, group_size: int, qmax: int):
    """Eq. 1 core: per-group S = 2*max|r|/(2*qmax+1), round-clip to
    [-qmax, qmax]. Returns (int8 logical values, f32 scales)."""
    g = _groups(r, group_size)
    absmax = g.abs().amax(dim=-1)
    scales = absmax * (2.0 / (2 * qmax + 1))
    # avoid 0/0 for all-zero groups; the scale is irrelevant there (q == 0)
    safe = torch.where(scales > 0, scales, 1.0)
    q = torch.clamp(torch.round(g / safe[..., None]), -qmax, qmax).to(torch.int8)
    return q.reshape(r.shape), scales


def largest_pow2_group(n: int, preferred: int, min_gs: int) -> int | None:
    """Largest power-of-two group size in [min_gs, preferred] dividing n:
    the one descent shared by :func:`choose_group_size` (floor 32) and
    ``policy.leaf_group_size`` (floor 16)."""
    gs = preferred
    while gs >= min_gs:
        if n % gs == 0:
            return gs
        gs //= 2
    return None


def choose_group_size(dims: list[int], preferred: int = DEFAULT_GROUP_SIZE,
                      min_gs: int = 32) -> int:
    """The largest power-of-two GS <= ``preferred`` (and >= ``min_gs``)
    dividing every quantized dim. The paper picks 256 because every
    TinyLlama dim divides by it; a 1408-wide FFN (deepseek-v2-lite) needs
    128."""
    gs = largest_pow2_group(reduce(math.gcd, dims), preferred, min_gs)
    if gs is None:
        raise ValueError(f"no group size in [{min_gs}, {preferred}] divides all of {dims}")
    return gs


# ---------------------------------------------------------------------------
# int8 (paper W8A8)
# ---------------------------------------------------------------------------

def quantize_groupwise(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Symmetric int8 group-wise quantization along the last axis (Eq. 1)."""
    q, scales = _group_quantize(r, group_size, qmax=127)
    return QuantizedTensor(qvalues=q, scales=scales, group_size=group_size, fmt="int8")


# ---------------------------------------------------------------------------
# int4, two nibbles per int8 byte (W4A8)
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], (..., n) -> packed int8 (..., n // 2): byte i
    holds element 2i in its low nibble and element 2i+1 in its high one."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last axis, got {tuple(q.shape)}")
    v = q.to(torch.int32) & 0x0F
    byte = v[..., 0::2] | (v[..., 1::2] << 4)
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Packed int8 (..., n // 2) -> sign-extended int8 values (..., n)."""
    u = p.to(torch.int32)
    lo = ((u & 0x0F) ^ 8) - 8
    hi = u >> 4                         # arithmetic: p is signed
    v = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return v.reshape(*p.shape[:-1], p.shape[-1] * 2)


def quantize_int4(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Packed-int4 group-wise quantization (Eq. 1 with b=4): S = 2*max|r|/15."""
    if group_size % 2:
        raise ValueError(f"int4 needs an even group_size, got {group_size}")
    q, scales = _group_quantize(r, group_size, qmax=7)
    return QuantizedTensor(pack_int4(q), scales, group_size, "int4")


# ---------------------------------------------------------------------------
# int3, eight 3-bit fields per three bytes (W3A8)
# ---------------------------------------------------------------------------

def pack_int3(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-3, 3], (..., n) -> packed uint8 (..., n // 8 * 3).

    Each run of 8 elements becomes one little-endian 24-bit word: element i
    in bits [3i, 3i+3) as a 3-bit two's-complement field, stored as bytes
    b0 = bits 0-7, b1 = 8-15, b2 = 16-23."""
    if q.shape[-1] % 8:
        raise ValueError(f"int3 packing needs a last axis divisible by 8, got {tuple(q.shape)}")
    u = (q.to(torch.int32) & 0x7).reshape(*q.shape[:-1], q.shape[-1] // 8, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=q.device) * 3
    w = (u << shifts).sum(dim=-1, dtype=torch.int32)
    b = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(*q.shape[:-1], q.shape[-1] // 8 * 3)


def unpack_int3(p: torch.Tensor) -> torch.Tensor:
    """Packed uint8 (..., 3k) -> sign-extended int8 values (..., 8k)."""
    if p.shape[-1] % 3:
        raise ValueError(f"int3 storage last axis must divide by 3, got {tuple(p.shape)}")
    b = p.to(torch.int32).reshape(*p.shape[:-1], p.shape[-1] // 3, 3)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    shifts = torch.arange(8, dtype=torch.int32, device=p.device) * 3
    f = (w[..., None] >> shifts) & 7
    v = ((f ^ 4) - 4).to(torch.int8)
    return v.reshape(*p.shape[:-1], p.shape[-1] // 3 * 8)


def quantize_int3(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Packed-int3 group-wise quantization (Eq. 1 with b=3): S = 2*max|r|/7."""
    if group_size % 8:
        raise ValueError(f"int3 needs a group_size divisible by 8, got {group_size}")
    q, scales = _group_quantize(r, group_size, qmax=3)
    return QuantizedTensor(pack_int3(q), scales, group_size, "int3")


# ---------------------------------------------------------------------------
# fp8 (e4m3 values, one f32 scale per group)
# ---------------------------------------------------------------------------

def quantize_fp8(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Group-wise fp8: S = max|r|/448 maps each group onto e4m3's range; the
    storage cast rounds to the nearest e4m3 value (ties to even)."""
    g = _groups(r, group_size)
    absmax = g.abs().amax(dim=-1)
    scales = absmax * (1.0 / FP8_MAX)
    safe = torch.where(scales > 0, scales, 1.0)
    q = (g / safe[..., None]).to(torch.float8_e4m3fn)
    return QuantizedTensor(q.reshape(r.shape), scales, group_size, "fp8")


register_format(QuantFormat(
    name="int8", bits=8, storage_dtype=torch.int8, pack=1, qmax=127, kernel="gqmv_int8",
    quantize_fn=quantize_groupwise))

register_format(QuantFormat(
    name="int4", bits=4, storage_dtype=torch.int8, pack=2, qmax=7, kernel="gqmv_int4",
    quantize_fn=quantize_int4, unpack_fn=unpack_int4))

register_format(QuantFormat(
    name="int3", bits=3, storage_dtype=torch.uint8, pack=8, pack_storage=3, qmax=3,
    kernel="gqmv_int3", quantize_fn=quantize_int3, unpack_fn=unpack_int3))

register_format(QuantFormat(
    name="fp8", bits=8, storage_dtype=torch.float8_e4m3fn, pack=1, qmax=int(FP8_MAX),
    kernel="gqmv_fp8", quantize_fn=quantize_fp8))


# ---------------------------------------------------------------------------
# generic entry points (format-dispatched)
# ---------------------------------------------------------------------------

def quantize(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
             fmt: str = "int8") -> QuantizedTensor:
    """Quantize ``r`` group-wise in registry format ``fmt``."""
    return get_format(fmt).quantize(r, group_size)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """r_hat = Q(r) * S (Eq. 2), its scales and output guarded when the
    numerics checks are on."""
    if _NUMERICS["on"]:
        _numerics_guard(f"dequantize[{qt.fmt}].scales", qt.scales)
    out = dequantize_unchecked(qt, dtype)
    if _NUMERICS["on"]:
        _numerics_guard(f"dequantize[{qt.fmt}].output", out)
    return out


def dequantize_unchecked(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """``dequantize`` without the tripwires: the model step's own dequantize
    (a host read per projection would stall every step)."""
    v = qt.format.unpack_values(qt.qvalues)
    g = v.reshape(*v.shape[:-1], qt.num_groups, qt.group_size)
    out = g.to(torch.float32) * qt.scales[..., None]
    return out.reshape(v.shape).to(dtype)


def quantize_activation(x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Run-time activation quantization (paper Alg. 2 lines 3/8/13/16):
    always int8, whatever the weight format."""
    return quantize_groupwise(x, group_size=group_size)


def quantization_error_stats(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
                             fmt: str = "int8") -> dict[str, float]:
    """Per-element |r_hat - r| statistics (paper Table IV, Eq. 3), in f32:
    max, min, mean and (population) std of the error, and the mean and std
    of the error relative to |r| in % (|r| = 0 counts as 1)."""
    qt = quantize(r, group_size, fmt)
    err = (qt.dequantize() - r.to(torch.float32)).abs()
    denom = torch.where(r.abs() > 0, r.abs(), 1.0).to(torch.float32)
    rel = err / denom
    return {
        "max": float(err.max()),
        "min": float(err.min()),
        "mean": float(err.mean()),
        "std": float(err.std(correction=0)),
        "rel_mean_pct": float(100.0 * rel.mean()),
        "rel_std_pct": float(100.0 * rel.std(correction=0)),
    }
