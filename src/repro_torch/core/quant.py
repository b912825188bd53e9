"""Group-wise int8 quantization (counterpart of ``repro/core/quant.py``).

The paper's symmetric group-wise PTQ with per-group f32 scales (Eq. 1/2):

  Q(r)  = Int(r / S),            S = 2 * max(|r|) / 255
  r_hat = Q(r) * S

with the last (contraction) axis split into groups of ``GS`` elements. Only
the ``int8`` format is ported so far; the reference's int4/int3/fp8 formats
raise "not yet ported". The arithmetic is bit-exact against the reference:
absmax and ``* (2/255)`` in f32, a true division, round half to even, clip
to [-127, 127] (the all-zero group keeps scale 0 and values 0).
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_GROUP_SIZE = 256  # paper §III-A: GS=256 divides every TinyLlama dim

PORTED_FORMATS = ("int8",)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A group-wise symmetric quantized tensor.

    ``qvalues`` is int8 with the logical shape (int8 is unpacked); ``scales``
    is f32 with the last axis reduced by ``group_size``. Groups run along
    the last axis, the contraction axis of the matmul that consumes it.
    """

    qvalues: torch.Tensor  # int8, shape (..., n)
    scales: torch.Tensor   # float32, shape (..., n // group_size)
    group_size: int
    fmt: str = "int8"

    @property
    def shape(self) -> tuple[int, ...]:
        """Logical shape: what ``dequantize()`` returns."""
        return tuple(self.qvalues.shape)

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


def _check_format(fmt: str) -> None:
    if fmt not in PORTED_FORMATS:
        raise NotImplementedError(
            f"quant format {fmt!r} is not yet ported to repro_torch; "
            f"ported: {PORTED_FORMATS}")


def _check_group_size(n: int, group_size: int) -> None:
    if n % group_size != 0:
        raise ValueError(
            f"last axis ({n}) must be divisible by group_size ({group_size}); "
            "pick GS per paper §III-A (GS must divide every quantized dim)")


def _group_quantize(r: torch.Tensor, group_size: int, qmax: int):
    """Eq. 1 core: per-group S = 2*max|r|/(2*qmax+1), round-clip to
    [-qmax, qmax]. Returns (int8 values, f32 scales)."""
    n = r.shape[-1]
    _check_group_size(n, group_size)
    g = r.reshape(*r.shape[:-1], n // group_size, group_size).to(torch.float32)
    absmax = g.abs().amax(dim=-1)
    scales = absmax * (2.0 / (2 * qmax + 1))
    # avoid 0/0 for all-zero groups; the scale is irrelevant there (q == 0)
    safe = torch.where(scales > 0, scales, 1.0)
    q = torch.clamp(torch.round(g / safe[..., None]), -qmax, qmax).to(torch.int8)
    return q.reshape(r.shape), scales


def quantize_groupwise(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Symmetric int8 group-wise quantization along the last axis (Eq. 1)."""
    q, scales = _group_quantize(r, group_size, qmax=127)
    return QuantizedTensor(qvalues=q, scales=scales, group_size=group_size, fmt="int8")


def _dequantize_int8(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """r_hat = Q(r) * S (Eq. 2)."""
    q = qt.qvalues
    g = q.reshape(*q.shape[:-1], qt.num_groups, qt.group_size)
    out = g.to(torch.float32) * qt.scales[..., None]
    return out.reshape(q.shape).to(dtype)


def quantize(r: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
             fmt: str = "int8") -> QuantizedTensor:
    _check_format(fmt)
    return quantize_groupwise(r, group_size)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    _check_format(qt.fmt)
    return _dequantize_int8(qt, dtype=dtype)


def quantize_activation(x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    """Run-time int8 activation quantization (paper Alg. 2 lines 3/8/13/16)."""
    return quantize_groupwise(x, group_size=group_size)


def largest_pow2_group(n: int, preferred: int, min_gs: int) -> int | None:
    """Largest power-of-two group size in [min_gs, preferred] dividing n."""
    gs = preferred
    while gs >= min_gs:
        if n % gs == 0:
            return gs
        gs //= 2
    return None
