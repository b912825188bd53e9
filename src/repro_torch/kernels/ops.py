"""Entry points for the quantized matmuls and paged decode attention
(counterpart of ``repro/kernels/ops.py``).

``impl`` picks the implementation, as in the reference:

  'auto'   the CUDA kernel for a CUDA tensor, the plain version for a CPU
           tensor (the CPU is the only reason the plain version runs)
  'cuda'   the CUDA kernel (raises for a CPU tensor)
  'plain'  the plain PyTorch version (``kernels/ref.py``) on any device

An ``impl`` of ``None`` takes the scope's default, which is 'auto' unless
:func:`impl_scope` says otherwise; the model code passes ``None``, so a
whole forward pass can be run on the plain versions (to compare with the
kernels on the card) without threading an argument through every layer.
There is no fallback: a CUDA tensor under 'auto' launches the kernel or
raises.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core.quant import QuantizedTensor, quantize_activation
from repro_torch.kernels import gqmv as _cuda
from repro_torch.kernels import paged_attn as _paged
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "cuda", "plain")
_SCOPE = {"impl": "auto"}


@contextlib.contextmanager
def impl_scope(impl: str):
    """Run the enclosed calls whose ``impl`` is None with ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    prev = _SCOPE["impl"]
    _SCOPE["impl"] = impl
    try:
        yield
    finally:
        _SCOPE["impl"] = prev


def _resolve(impl: str | None, t: torch.Tensor) -> str:
    impl = _SCOPE["impl"] if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "plain"
    return impl


def gqmv(wq, ws, xq, xs, *, group_size: int, impl: str | None = None) -> torch.Tensor:
    """out (m,) = groupwise-quantized W (m, n) @ x (n,). Paper Alg. 1."""
    if _resolve(impl, wq) == "cuda":
        return _cuda.gqmv_cuda(wq, ws, xq, xs, group_size=group_size)
    return _ref.gqmv_ref(wq, ws, xq, xs, group_size=group_size)


def gqmm(wq, ws, xq, xs, *, group_size: int, impl: str | None = None) -> torch.Tensor:
    """out (b, m) = batched GQMV; b = tokens for prefill / batch for decode."""
    if _resolve(impl, wq) == "cuda":
        return _cuda.gqmm_cuda(wq, ws, xq, xs, group_size=group_size)
    return _ref.gqmm_ref(wq, ws, xq, xs, group_size=group_size)


def paged_attention(q, k_pages, v_pages, block_table, pos, k_new, v_new, mask, *,
                    scale: float, softcap: float | None = None, k_scales=None,
                    v_scales=None, impl: str | None = None) -> torch.Tensor:
    """One paged decode-attention step -> ctx (b, KV*G*hd).

    q (b, KV, G, hd); pools (NB, BS, KV, hd) float, or int8/fp8 with
    per-row f32 ``k_scales``/``v_scales`` (NB, BS, KV); block_table (b, MB);
    pos (b,); k_new/v_new (b, KV, hd) the current token's uncommitted rows;
    mask (b, MB*BS) additive (a decode mask: see ``kernels/paged_attn.py``).
    The plain version gathers the virtual sequence through the block table;
    the CUDA kernel reads only the live blocks and dequantizes in-kernel."""
    args = (q, k_pages, v_pages, block_table, pos, k_new, v_new, mask)
    kw = dict(scale=scale, softcap=softcap, k_scales=k_scales, v_scales=v_scales)
    if _resolve(impl, q) == "cuda":
        return _paged.paged_attention_cuda(*args, **kw)
    return _ref.paged_attention_ref(*args, **kw)


def quantized_matmul(x: torch.Tensor, w: QuantizedTensor, *,
                     impl: str | None = None) -> torch.Tensor:
    """y = x @ dequant(w).T with run-time int8 activation quantization.

    ``x`` is float (..., n); ``w`` an int8 QuantizedTensor (m, n). Returns
    float32 (..., m). A 1-D ``x`` goes to GQMV, anything else (flattened to
    rows) to GQMM, the reference's dispatch.
    """
    if w.fmt != "int8":
        raise NotImplementedError(f"kernels for format {w.fmt!r} are not yet ported")
    xq = quantize_activation(x, group_size=w.group_size)
    lead = x.shape[:-1]
    if lead == ():
        return gqmv(w.qvalues, w.scales, xq.qvalues, xq.scales,
                    group_size=w.group_size, impl=impl)
    flat_q = xq.qvalues.reshape(-1, x.shape[-1])
    flat_s = xq.scales.reshape(-1, xq.scales.shape[-1])
    out = gqmm(w.qvalues, w.scales, flat_q, flat_s, group_size=w.group_size, impl=impl)
    return out.reshape(*lead, w.shape[0])
