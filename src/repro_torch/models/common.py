"""Shared model building blocks (counterpart of ``repro/models/common.py``):
norms, RoPE, activations, init, masks.

Functions on tensors; parameters are nested dicts. Weight matrices keep the
paper's (out, in) layout so quantization groups run along the contraction
axis. Random initialisation takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, out_dim: int, in_dim: int, dtype,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 1/in_dim) weights (out, in), drawn in f32 on ``gen``'s device;
    ``lead`` stacks independent draws, e.g. (num_layers,)."""
    x = torch.randn((*lead, out_dim, in_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * in_dim ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    x = torch.randn((vocab, dim), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype (the reference's rounding).
    gemma2 stores w - 1 and applies (1 + w): ``plus_one`` selects that."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * _norm_scale(w, plus_one)).to(dt)


def _norm_scale(w: torch.Tensor, plus_one: bool) -> torch.Tensor:
    w32 = w.to(torch.float32)
    return 1.0 + w32 if plus_one else w32


def rmsnorm_steps(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, *,
                  plus_one: bool = False) -> torch.Tensor:
    """:func:`rmsnorm` of a speculative-verify chunk x (b, k, d) whose sums of
    squares run over each chunk column's (b, d) rows apart, as k decode
    steps of b rows sum them: PyTorch's CUDA reduction splits a row's sum
    by how many rows it reduces (at b = 4 across warps, at 16 one warp a
    row), and a verify row must round as its decode step does. Everything
    else is elementwise, the same op for op."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    sq = (x32 * x32).transpose(0, 1).contiguous()                 # (k, b, d)
    ms = torch.stack([sq[m].mean(dim=-1, keepdim=True) for m in range(sq.shape[0])], dim=1)
    inv = torch.rsqrt(ms + eps)
    return (x32 * inv * _norm_scale(w, plus_one)).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2's logit soft cap, cap * tanh(x / cap), in x's dtype (the
    reference's order: divide, tanh, multiply)."""
    return cap * torch.tanh(x / cap)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def remat_call(fn, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``fn(x)``, under ``torch.utils.checkpoint`` (non-reentrant) where
    ``remat`` is set and grad is enabled: only x is kept and ``fn`` runs
    again in the backward, as under the reference's ``jax.checkpoint`` of a
    layer."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    return fn(x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, device=x.device)                 # (dim/2,)
    angles = positions[..., None].to(torch.float32) * freqs         # (..., seq, dim/2)
    cos = torch.cos(angles)[..., None, :]                           # (..., seq, 1, dim/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def causal_mask(seq: int, window: int | None = None, device=None) -> torch.Tensor:
    """(seq, seq) additive mask; ``window`` enables sliding-window locality."""
    q = torch.arange(seq, device=device)[:, None]
    k = torch.arange(seq, device=device)[None, :]
    ok = k <= q
    if window is not None:
        ok &= (q - k) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def decode_mask(cache_len: int, pos, window: int | None = None, device=None) -> torch.Tensor:
    """Additive mask for one decode step: slots > pos are masked. ``pos`` an
    int (or 0-d tensor) gives (cache_len,); a (b,) tensor gives (b, cache_len)."""
    if isinstance(pos, torch.Tensor):
        device = pos.device
    k = torch.arange(cache_len, device=device)
    if isinstance(pos, torch.Tensor) and pos.ndim:
        k = k[None, :]
        pos = pos[:, None]
    ok = k <= pos
    if window is not None:
        ok &= (pos - k) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def length_mask(lengths: torch.Tensor, kv_len: int) -> torch.Tensor:
    """(b, kv_len) additive mask hiding right-pad keys at positions >= length."""
    ok = torch.arange(kv_len, device=lengths.device)[None, :] < lengths[:, None]
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)
