"""Entry points for the quantized matmuls, paged decode attention, flash
attention and the fused RMSNorm + quantize (counterpart of
``repro/kernels/ops.py`` and of the reference's Pallas entry points
``flash_attention_pallas`` / ``rmsnorm_quant_pallas``).

The weight format picks the GQMV/GQMM pair: every registered
:class:`~repro_torch.core.quant.QuantFormat` names a kernel hook
(``fmt.kernel``), and ``KERNEL_HOOKS`` maps it to the CUDA kernels and
their plain versions, as the reference's table maps it to its Pallas
kernels and XLA oracles. ``impl`` picks the implementation, as in the
reference:

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
import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.quant import QuantizedTensor, get_format, quantize_activation
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import gqmv as _cuda
from repro_torch.kernels import paged_attn as _paged
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm_quant as _rmsq


@dataclasses.dataclass(frozen=True)
class KernelHook:
    """GQMV/GQMM implementations for one weight storage format, all with the
    signature (wq, ws, xq, xs, *, group_size); ``wq`` is the format's
    storage array (packed for int4/int3), activations are int8."""

    gqmv_cuda: Callable
    gqmm_cuda: Callable
    gqmv_plain: Callable
    gqmm_plain: Callable


def _cuda_pair(fmt: str) -> tuple[Callable, Callable]:
    return (functools.partial(_cuda.gqmv_cuda, fmt=fmt),
            functools.partial(_cuda.gqmm_cuda, fmt=fmt))


KERNEL_HOOKS: dict[str, KernelHook] = {
    "gqmv_int8": KernelHook(*_cuda_pair("int8"), _ref.gqmv_ref, _ref.gqmm_ref),
    "gqmv_int4": KernelHook(*_cuda_pair("int4"), _ref.gqmv_int4_ref, _ref.gqmm_int4_ref),
    "gqmv_int3": KernelHook(*_cuda_pair("int3"), _ref.gqmv_int3_ref, _ref.gqmm_int3_ref),
    "gqmv_fp8": KernelHook(*_cuda_pair("fp8"), _ref.gqmv_fp8_ref, _ref.gqmm_fp8_ref),
}


def _hook(kernel: str) -> KernelHook:
    try:
        return KERNEL_HOOKS[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel hook {kernel!r}; registered: "
                         f"{sorted(KERNEL_HOOKS)}") from None

# the active step recorders (analysis/program.py): each entry point below is
# one node of a recorded step, and the ops it runs inside are not recorded
# apart (on the card they are the kernel's own registers)
RECORDERS: list = []


def _entry(fn: Callable) -> Callable:
    """An entry point that the innermost active recorder records whole."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not RECORDERS:
            return fn(*args, **kwargs)
        return RECORDERS[-1].entry(fn, args, kwargs)
    return call


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


def scope_impl() -> str:
    """The implementation the enclosing :func:`impl_scope` sets ('auto'
    outside any): part of a captured program's key (``serving/graphs.py``)."""
    return _SCOPE["impl"]


def _resolve(impl: str | None, t: torch.Tensor) -> str:
    impl = _SCOPE["impl"] if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return "cuda" if t.is_cuda else "plain"
    return impl


def gqmv(wq, ws, xq, xs, *, group_size: int, impl: str | None = None,
         kernel: str = "gqmv_int8") -> torch.Tensor:
    """out (m,) = groupwise-quantized W (m, n) @ x (n,). Paper Alg. 1.
    ``wq`` is the storage array of the format that owns ``kernel``."""
    hook = _hook(kernel)
    fn = hook.gqmv_cuda if _resolve(impl, wq) == "cuda" else hook.gqmv_plain
    return fn(wq, ws, xq, xs, group_size=group_size)


def gqmm(wq, ws, xq, xs, *, group_size: int, impl: str | None = None,
         kernel: str = "gqmv_int8") -> torch.Tensor:
    """out (b, m) = batched GQMV; b = tokens for prefill / batch for decode."""
    hook = _hook(kernel)
    fn = hook.gqmm_cuda if _resolve(impl, wq) == "cuda" else hook.gqmm_plain
    return fn(wq, ws, xq, xs, group_size=group_size)


@_entry
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


@_entry
def flash_attention(q, k, v, *, group: int, scale: float, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    impl: str | None = None) -> torch.Tensor:
    """Chunked online-softmax attention -> out (b*H, s, hd) in q's dtype.

    q (b*H, s, hd), k and v (b*KV, t, hd), batch and heads flattened; query
    row i reads K/V row i // group. Scores in f32: scale, soft cap, causal and
    window masks counted from position 0, online softmax (see
    ``kernels/ref.flash_attention_ref``). The CUDA kernel skips the tiles
    above the diagonal and outside the window; the plain version walks
    ``flags.attention_chunk`` chunks of every key.

    With grad enabled and q, k or v requiring grad the call goes through
    :class:`FlashAttention`, whose backward is the hand-written backward
    kernel on the card (the plain backward on the CPU); otherwise it is the
    forward alone."""
    kw = dict(group=group, scale=scale, causal=causal, window=window, softcap=softcap)
    impl = _resolve(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, impl, group, scale, causal, window, softcap)
    if impl == "cuda":
        return _flash.flash_attention_cuda(q, k, v, **kw)
    return _ref.flash_attention_ref(q, k, v, **kw)


class FlashAttention(torch.autograd.Function):
    """B4 with a backward: the forward also writes each query row's f32
    log-sum-exp (b*H, s), and the backward recomputes the softmax weights
    from Q, K and it (FlashAttention-2's scheme) for dQ, dK and dV: the
    CUDA kernels ``flash_attn`` / ``flash_attn_f32`` and ``flash_attn_bwd``
    for ``impl`` 'cuda', ``kernels/ref.flash_attention_ref`` /
    ``flash_attention_bwd_ref`` for 'plain'. dK and dV sum over each KV
    head's group of query heads; the gradients come back in the inputs'
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, impl, group, scale, causal, window, softcap):
        kw = dict(group=group, scale=scale, causal=causal, window=window, softcap=softcap)
        if impl == "cuda":
            out, lse = _flash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        else:
            out, lse = _ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.impl, ctx.kw = impl, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.impl == "cuda":
            dq, dk, dv = _flash.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **ctx.kw)
        else:
            dq, dk, dv = _ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


@_entry
def rmsnorm_quant(x, w, *, group_size: int, eps: float = 1e-5,
                  impl: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused RMSNorm and int8 group quantization of x (m, n) with weight w
    (n,) -> (int8 (m, n), f32 scales (m, n / group_size)). A standalone op:
    the model keeps the reference's unfused ``rmsnorm`` + activation
    quantization."""
    if _resolve(impl, x) == "cuda":
        return _rmsq.rmsnorm_quant_cuda(x, w, group_size=group_size, eps=eps)
    return _ref.rmsnorm_quant_ref(x, w, group_size=group_size, eps=eps)


@_entry
def quantized_matmul(x: torch.Tensor, w: QuantizedTensor, *,
                     impl: str | None = None, xq: QuantizedTensor | None = None
                     ) -> torch.Tensor:
    """y = x @ dequant(w).T with run-time int8 activation quantization.

    ``x`` is float (..., n); ``w`` a QuantizedTensor (m, n logical) in any
    registered format, whose kernel hook picks the GQMV/GQMM pair. Returns
    float32 (..., m). A 1-D ``x`` goes to GQMV, anything else (flattened to
    rows) to GQMM, the reference's dispatch. ``xq``, x's int8 activations
    at w's group size (``quantize_activation``), skips quantizing x again
    where several weights take one input (the MoE experts' ``w13``).
    """
    kernel = get_format(w.fmt).kernel
    if xq is None:
        xq = quantize_activation(x, group_size=w.group_size)
    lead = x.shape[:-1]
    if lead == ():
        return gqmv(w.qvalues, w.scales, xq.qvalues, xq.scales,
                    group_size=w.group_size, impl=impl, kernel=kernel)
    flat_q = xq.qvalues.reshape(-1, x.shape[-1])
    flat_s = xq.scales.reshape(-1, xq.scales.shape[-1])
    out = gqmm(w.qvalues, w.scales, flat_q, flat_s, group_size=w.group_size, impl=impl,
               kernel=kernel)
    return out.reshape(*lead, w.shape[0])
