"""Quantization-aware linear / embedding primitives (counterpart of
``repro/core/qlinear.py``).

Every weight-bearing matmul goes through ``linear``: a plain tensor weight
is an ordinary matmul in the activation's dtype; a
:class:`~repro_torch.core.quant.QuantizedTensor` weight becomes the paper's
GQMV/GQMM (run-time int8 activation quantization + the group-wise kernel
of the weight's format: W8A8, W4A8, W3A8 or fp8 weights). Weights keep the
paper's (out, in) layout with groups along in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import flags
from repro_torch.core.quant import QuantizedTensor, dequantize_unchecked
from repro_torch.kernels import ops

__all__ = ["linear", "embedding_lookup", "quantize_input", "split_fused"]


def linear(w, x: torch.Tensor, xq: QuantizedTensor | None = None) -> torch.Tensor:
    """y = x @ W^T for W (out, in); the quantized kernel when W is quantized.
    The kernel's f32 output is rounded to the activation dtype, as in the
    reference. ``xq`` is x's int8 activations from :func:`quantize_input`
    (None: quantized here).

    Under ``flags.prefill_dequant`` a quantized weight is dequantized to the
    activation dtype and multiplied as a float matrix, for every call while
    the flag is set (decode too), as the reference's code does; the
    reference leaves that product to XLA, so no kernel of the port runs."""
    if isinstance(w, QuantizedTensor):
        if flags.get("prefill_dequant"):
            return torch.einsum("...i,oi->...o", x, dequantize_unchecked(w, x.dtype))
        if xq is None:      # the call the trace tools wrap (tests/trace_torch_*.py)
            return ops.quantized_matmul(x, w).to(x.dtype)
        return ops.quantized_matmul(x, w, xq=xq).to(x.dtype)
    return F.linear(x, w.to(x.dtype))


def quantize_input(w, x: torch.Tensor) -> QuantizedTensor | None:
    """x's int8 activations for the quantized kernel of ``w`` (None where
    ``linear`` runs no kernel): quantize an input once, then hand it to
    ``linear`` with every weight of that leaf that takes it, as the
    reference's ``vmap`` over the MoE experts quantizes their shared input
    once."""
    if not isinstance(w, QuantizedTensor) or flags.get("prefill_dequant"):
        return None
    return ops.quantize_activation(x, group_size=w.group_size)


def embedding_lookup(w, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Row gather from a (vocab, d) table; dequantizes only the gathered rows
    when the table is quantized (the paper quantizes W_embeddings). Packed
    formats gather their storage rows and unpack them."""
    if isinstance(w, QuantizedTensor):
        q = w.qvalues[ids]                          # (..., d / pack * pack_storage)
        s = w.scales[ids]                           # (..., d / GS)
        v = w.format.unpack_values(q)               # (..., d) logical values
        g = v.reshape(*v.shape[:-1], w.num_groups, w.group_size).to(dtype)
        return (g * s[..., None].to(dtype)).reshape(v.shape)
    return w[ids].to(dtype)


def split_fused(y: torch.Tensor, sizes: tuple[int, ...]):
    """Split the output of a fused projection (paper Alg. 2 lines 4, 12)."""
    outs, off = [], 0
    for s in sizes:
        outs.append(y[..., off:off + s])
        off += s
    if off != y.shape[-1]:
        raise ValueError(
            f"split_fused sizes {tuple(sizes)} sum to {off} but the fused "
            f"output has trailing dim {y.shape[-1]} (shape {tuple(y.shape)})")
    return outs
