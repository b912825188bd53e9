"""GQA attention (counterpart of the GQA half of ``repro/models/attention.py``).

Only the reference's default path is ported: full ``_mha`` attention in
prefill and decode over the base (b, T, KV, hd) cache layout, with
``blockwise_attention``, ``deferred_decode_cache``, the kvt layout and
quantized KV off. The mask selectors keep the reference's sliding-window
arguments, which stay None until a windowed config (gemma2) is ported. The
sharding annotations (``logical.constrain``) come with the sharding slice.

Projections go through ``linear``, so the same code runs float weights or
the W8A8 kernels. QKV is one fused projection (paper Alg. 2 line 4).

``pos`` in the decode path is an int (uniform batch) or a (b,) tensor of
per-request positions (ragged batch), as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import linear, split_fused
from repro_torch.models.common import (
    apply_rope,
    causal_mask,
    decode_mask,
    dense_init,
    length_mask,
)


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    """(b, 1) RoPE position rows from an int, 0-d or (b,) ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(b, 1) if pos.ndim else pos.reshape(1, 1).expand(b, 1)
    return torch.full((b, 1), pos, dtype=torch.long, device=device)


def _commit_bt(cache: torch.Tensor, rows: torch.Tensor, pos) -> torch.Tensor:
    """Write rows (b, 1, ...) into cache (b, T, ...) at time ``pos``.

    Writes IN PLACE (the reference returns an updated copy): ``cache`` is a
    view into the stacked (L, b, T, ...) cache, which therefore holds the
    new rows afterwards."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = rows[:, 0]
    else:
        cache[:, pos] = rows[:, 0]
    return cache


def _bcast_decode_mask(m: torch.Tensor) -> torch.Tensor:
    """decode mask (t,) or (b, t) -> broadcastable over (b, s=1, t) scores."""
    return m[None, None, :] if m.ndim == 1 else m[:, None, :]


def init_gqa(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    dt = cfg.pdtype()
    return {
        "wqkv": dense_init(gen, cfg.q_dim + 2 * cfg.kv_dim, cfg.d_model, dt, lead),
        "wo": dense_init(gen, cfg.d_model, cfg.q_dim, dt, lead),
    }


def _gqa_scale(cfg: ModelConfig) -> float:
    base = cfg.query_scale if cfg.query_scale is not None else cfg.resolved_head_dim
    return base ** -0.5


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = split_fused(linear(p["wqkv"], x), (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _mha(q, k, v, mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q: (b,s,H,hd); k,v: (b,t,KV,hd); mask additive (s,t) or (b,s,t)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = scores * _gqa_scale(cfg)
    scores = scores + (mask[None, None, None] if mask.ndim == 2 else mask[:, None, None])
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", attn, v)
    return out.reshape(b, s, h * hd)


def _flag_mask(s: int, window, use_window, device) -> torch.Tensor:
    """(s, s) additive mask; ``use_window`` (a bool tensor) selects the
    sliding-window variant per layer (gemma2's local/global alternation)."""
    full = causal_mask(s, None, device=device)
    if window is None:
        return full
    local = causal_mask(s, window, device=device)
    if use_window is None:
        return local
    return torch.where(use_window, local, full)


def _flag_decode_mask(cache_len: int, pos, window, use_window, device) -> torch.Tensor:
    full = decode_mask(cache_len, pos, None, device=device)
    if window is None:
        return full
    local = decode_mask(cache_len, pos, window, device=device)
    if use_window is None:
        return local
    return torch.where(use_window, local, full)


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, cache_len: int, *, window=None,
                use_window=None, lengths: torch.Tensor | None = None):
    """Returns (y, (k_cache, v_cache)) with caches padded to cache_len.

    ``lengths`` (b,) marks each row's true prompt length in a right-padded
    batch: keys at positions >= lengths[i] are masked out and their K/V rows
    zeroed before caching, as in the reference."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    mask = _flag_mask(s, window, use_window, x.device)
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :] < lengths[:, None])[..., None, None]
        k = torch.where(valid, k, 0)
        v = torch.where(valid, v, 0)
        mask = mask[None] + length_mask(lengths, s)[:, None, :]     # (b, s, s)
    ctx = _mha(q, k, v, mask, cfg)
    pad = (0, 0, 0, 0, 0, cache_len - s)                            # time axis 1
    return linear(p["wo"], ctx), (F.pad(k, pad), F.pad(v, pad))


def gqa_decode(p, x: torch.Tensor, cache, pos, cfg: ModelConfig, *, window=None,
               use_window=None):
    """x: (b, d_model) one token; cache: (k, v) each (b, T, KV, hd), updated
    in place; pos: int or (b,) positions. Returns (y, cache)."""
    k_cache, v_cache = cache
    b = x.shape[0]
    q, k, v = _qkv(p, x[:, None, :], cfg, _pos_rows(pos, b, x.device))
    k_cache = _commit_bt(k_cache, k, pos)
    v_cache = _commit_bt(v_cache, v, pos)
    mask = _bcast_decode_mask(
        _flag_decode_mask(k_cache.shape[1], pos, window, use_window, x.device))
    ctx = _mha(q, k_cache, v_cache, mask, cfg)                      # (b, 1, q_dim)
    return linear(p["wo"], ctx[:, 0, :]), (k_cache, v_cache)
