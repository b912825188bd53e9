"""Attention (counterpart of ``repro/models/attention.py``): GQA, and MLA
(multi-head latent attention, minicpm3 and deepseek-v2-lite: the scoring /
prefill ``mla_forward`` and ``mla_prefill`` materialize K/V from the latent
through ``wukv``; the absorbed decode ``mla_decode`` / ``mla_decode_deferred``
folds ``wukv``, dequantized to f32, into the query and the output, and
attends over the latent cache itself; plain PyTorch, as the reference's
einsums).

Ported GQA paths, under the reference's default flags and its
perf-variant flags (``core/flags.py``):

- full ``_mha`` attention in the scoring forward (``gqa_forward``),
  prefill and decode over the base (b, T, KV, hd) cache layout;
- ``blockwise_attention``: ``_mha_blockwise`` in the forward and in
  prefill, through ``kernels/ops.flash_attention`` (the CUDA flash kernel
  on the card);
- ``deferred_decode_cache``: ``gqa_decode_deferred`` reads the cache only
  and returns the new K/V rows, committed after the last layer with
  ``commit_layers_bt``;
- ``kvt_cache_layout``: the float cache stored (b, KV, T, hd), written by
  ``gqa_prefill``, read by ``gqa_decode_deferred`` and committed with
  ``commit_layers_bkt``;
- the quantized KV cache (``cfg.kv_quant`` "int8"/"fp8", or the
  ``int8_kv_cache`` flag): kvt-major rows with per-row f32 scales, written
  by ``gqa_prefill`` and read by ``gqa_decode_deferred_quant``;
- paged decode over a block pool (``gqa_decode_paged``), float or
  quantized, through ``kernels/ops.paged_attention`` (the CUDA kernel on
  the card), with the deferred commits ``commit_layers_paged`` /
  ``commit_layers_bkt``;
- speculative verify of a k-token chunk over the contiguous cache
  (``gqa_verify``) or the block pool (``gqa_verify_paged``), base float
  layout: the chunk's projections run once over its b·k rows, and each
  chunk column attends through the decode step's own attention (``_mha``,
  ``_attend_deferred`` or ``kernels/ops.paged_attention``), so a verify row
  sums as its decode step does; the accepted prefix is committed with
  ``commit_layers_verify`` / ``commit_layers_paged_verify``.

Every path takes the reference's sliding-window arguments: ``window``
(gemma2's ``cfg.sliding_window``) and ``use_window``, the layer's static
bool from ``transformer._layer_windows`` (so a captured step has each
layer's mask baked in). ``cfg.attn_logit_softcap`` caps the scores where
the reference caps them: after the scale, before the mask (``_mha``,
``_attend_deferred``, ``gqa_decode_deferred_quant``, and inside the flash
and paged kernels). The sharding annotations (``logical.constrain``) come
with the sharding slice.

Projections go through ``linear``, so the same code runs float weights or
the W8A8 kernels. QKV is one fused projection (paper Alg. 2 line 4).

``pos`` in the decode path is an int (uniform batch) or a (b,) tensor of
per-request positions (ragged batch), as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import flags
from repro_torch.core.qlinear import linear, split_fused
from repro_torch.core.quant import FP8_MAX, QuantizedTensor, dequantize_unchecked
from repro_torch.kernels import ops
from repro_torch.models.common import (
    apply_rope,
    causal_mask,
    decode_mask,
    dense_init,
    length_mask,
    rmsnorm,
    softcap,
)


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    """(b, 1) RoPE position rows from an int, 0-d or (b,) ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(b, 1) if pos.ndim else pos.reshape(1, 1).expand(b, 1)
    return torch.full((b, 1), pos, dtype=torch.long, device=device)


def _put_rows(dst: torch.Tensor, index: tuple, val: torch.Tensor, pos: torch.Tensor,
              t: int, row_dim: int) -> None:
    """``dst[index] = val`` for per-row positions ``pos`` (b,) along a time
    axis of length ``t`` (``index`` built from ``pos`` clamped to t - 1):
    a row whose position lies past the axis writes nothing, as the
    reference's out-of-bounds scatter drops it. Such a row is a continuous
    batch's slot that finished within its chunk and idles frozen; its
    target gets back the bits it holds. ``row_dim``: the axis of ``val``
    that is the row."""
    ok = (pos < t).view(*(1,) * row_dim, -1, *(1,) * (val.ndim - row_dim - 1))
    dst[index] = torch.where(ok, val, dst[index])


def _commit_bt(cache: torch.Tensor, rows: torch.Tensor, pos) -> torch.Tensor:
    """Write rows (b, 1, ...) into cache (b, T, ...) at time ``pos``.

    Writes IN PLACE (the reference returns an updated copy): ``cache`` is a
    view into the stacked (L, b, T, ...) cache, which therefore holds the
    new rows afterwards. A per-row position past T writes nothing."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        t = cache.shape[1]
        idx = (torch.arange(cache.shape[0], device=cache.device), pos.clamp(max=t - 1))
        _put_rows(cache, idx, rows[:, 0], pos, t, 0)
    else:
        cache[:, pos] = rows[:, 0]
    return cache


def _commit_bkt(cache: torch.Tensor, rows: torch.Tensor, pos) -> torch.Tensor:
    """Write rows (b, KV, 1, ...) into cache (b, KV, T, ...) at time ``pos``,
    in place (the reference returns an updated copy); a per-row position
    past T writes nothing."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        b, kv, t = cache.shape[:3]
        dev = cache.device
        idx = (torch.arange(b, device=dev)[:, None], torch.arange(kv, device=dev)[None, :],
               pos.clamp(max=t - 1)[:, None])
        _put_rows(cache, idx, rows[:, :, 0], pos, t, 0)
    else:
        cache[:, :, pos] = rows[:, :, 0]
    return cache


def _col_update(scores: torch.Tensor, cur: torch.Tensor, pos) -> torch.Tensor:
    """scores (b, ..., t): overwrite column ``pos`` (per row when a (b,)
    tensor; a position past t writes nothing) with cur (b, ...), in place."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        t = scores.shape[-1]
        idx = (torch.arange(scores.shape[0], device=scores.device),) + (
            slice(None),) * (scores.ndim - 2) + (pos.clamp(max=t - 1),)
        _put_rows(scores, idx, cur, pos, t, 0)
    else:
        scores[..., pos] = cur
    return scores


def _col_at(attn: torch.Tensor, pos) -> torch.Tensor:
    """attn (b, ..., t) -> (b, ..., 1) column at ``pos`` (per row when a
    tensor; a position past t reads column t - 1, as the reference's
    gather clamps)."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        idx = (torch.arange(attn.shape[0], device=attn.device),) + (
            slice(None),) * (attn.ndim - 2) + (pos.clamp(max=attn.shape[-1] - 1),)
        return attn[idx][..., None]
    return attn[..., pos:pos + 1]


def _bcast_decode_mask(m: torch.Tensor) -> torch.Tensor:
    """decode mask (t,) or (b, t) -> broadcastable over (b, s=1, t) scores."""
    return m[None, None, :] if m.ndim == 1 else m[:, None, :]


def commit_layers_bt(cache: torch.Tensor, rows: torch.Tensor, pos) -> torch.Tensor:
    """Deferred-decode commit, (L, b, T, ...) layout: write rows
    (L, b, 1, ...) at time ``pos`` (an int, or (b,) per-row positions; one
    past T writes nothing), for all layers at once, in place (the reference
    returns an updated copy)."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        t = cache.shape[2]
        idx = (slice(None), torch.arange(cache.shape[1], device=cache.device),
               pos.clamp(max=t - 1))
        _put_rows(cache, idx, rows[:, :, 0], pos, t, 1)
    else:
        cache[:, :, pos] = rows[:, :, 0]
    return cache


def commit_layers_paged(pages: torch.Tensor, rows: torch.Tensor, block_table: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """Deferred paged commit: write rows (L, b, KV[, hd]) into the block pool
    (L, NB, BS, KV[, hd]) at each row's (physical block, offset) for virtual
    position ``pos`` (b,), for all layers at once, IN PLACE (the reference
    returns an updated copy). The block index is clamped to the table width
    so a frozen position never escapes its own table row. Duplicate targets
    (frozen slots all mapped to the sink block 0) are harmless."""
    bs = pages.shape[2]
    b = rows.shape[1]
    idx = torch.clamp(pos // bs, max=block_table.shape[1] - 1)
    phys = block_table[torch.arange(b, device=pages.device), idx].long()
    pages[:, phys, pos % bs] = rows
    return pages


def _masked_put(dst: torch.Tensor, index: tuple, rows: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """``dst[index] = rows`` where ``keep``; elsewhere each target gets back
    the bits it holds. PyTorch's scatter has no out-of-bounds drop (the
    reference's rejected-row route), and selecting the kept pairs would
    take a data-dependent host read; so every target is written and a
    rejected one changes no bit. ``index`` selects (L, b, k, ...) targets,
    which must be distinct among kept pairs; ``keep`` (b, k)."""
    old = dst[index]
    dst[index] = torch.where(keep.view(1, *keep.shape, *(1,) * (rows.ndim - 3)), rows, old)
    return dst


def commit_layers_verify(cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                         n_commit: torch.Tensor) -> torch.Tensor:
    """Speculative-verify commit, (L, b, T, KV, hd) layout: write the chunk's
    rows (L, b, k, KV, hd) at times ``pos + j`` for the accepted prefix
    ``j < n_commit[b]`` only, in place (the reference returns a copy). A
    rejected row changes no bit (``_masked_put``), so the cache after a
    partial accept is bit-identical to one that never saw the rejected
    drafts: rollback is a position rewind. ``pos + k`` must lie within T
    (the callers' ``spec_k`` slack)."""
    b, k = rows.shape[1], rows.shape[2]
    j = torch.arange(k, device=cache.device)[None, :]
    cols = pos.long()[:, None] + j                                      # (b, k)
    rows_i = torch.arange(b, device=cache.device)[:, None]
    return _masked_put(cache, (slice(None), rows_i, cols), rows, j < n_commit[:, None])


def commit_layers_paged_verify(pages: torch.Tensor, rows: torch.Tensor,
                               block_table: torch.Tensor, pos: torch.Tensor,
                               n_commit: torch.Tensor) -> torch.Tensor:
    """Speculative-verify commit into the block pool (L, NB, BS, KV, hd), in
    place: row j of the chunk lands at virtual position ``pos + j``'s
    (physical block, offset) for ``j < n_commit`` only. A rejected row
    changes no bit (``_masked_put``); the reference drops it past the
    pool's block axis, not into the sink block 0, which under the engine's
    identity tables is a live block. Accepted rows lie in allocated blocks,
    each a row's own, so their targets are distinct."""
    bs = pages.shape[2]
    b, k = rows.shape[1], rows.shape[2]
    j = torch.arange(k, device=pages.device)[None, :]
    vpos = pos.long()[:, None] + j                                      # (b, k)
    idx = torch.clamp(vpos // bs, max=block_table.shape[1] - 1)
    phys = torch.gather(block_table.long(), 1, idx)                     # (b, k)
    return _masked_put(pages, (slice(None), phys, vpos % bs), rows, j < n_commit[:, None])


def commit_layers_bkt(cache: torch.Tensor, rows: torch.Tensor, pos) -> torch.Tensor:
    """Deferred-decode commit, (L, b, KV, T, ...) layout (the kvt and
    quantized caches): write rows (L, b, KV, 1, ...) at time ``pos`` (a
    per-row position past T writes nothing), in place."""
    if isinstance(pos, torch.Tensor) and pos.ndim:
        b, kv, t = cache.shape[1], cache.shape[2], cache.shape[3]
        dev = cache.device
        idx = (slice(None), torch.arange(b, device=dev)[:, None],
               torch.arange(kv, device=dev)[None, :], pos.clamp(max=t - 1)[:, None])
        _put_rows(cache, idx, rows[:, :, :, 0], pos, t, 1)
    else:
        cache[:, :, :, pos] = rows[:, :, :, 0]
    return cache


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


def _scale_cap(scores: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The f32 scores times the query scale, then gemma2's attention soft
    cap where the config has one (the reference's order: scale, cap, mask)."""
    scores = scores * _gqa_scale(cfg)
    if cfg.attn_logit_softcap:
        scores = softcap(scores, cfg.attn_logit_softcap)
    return scores


def _mha(q, k, v, mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q: (b,s,H,hd); k,v: (b,t,KV,hd); mask additive (s,t) or (b,s,t)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = _scale_cap(scores, cfg)
    scores = scores + (mask[None, None, None] if mask.ndim == 2 else mask[:, None, None])
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", attn, v)
    return out.reshape(b, s, h * hd)


def _mha_blockwise(q, k, v, cfg: ModelConfig, *, causal=True, window=None,
                   use_window=None, lengths=None) -> torch.Tensor:
    """Chunked online-softmax attention (flash-style), the reference's
    ``_mha_blockwise`` with its signature; q (b, s, H, hd), k and v
    (b, t, KV, hd) -> (b, s, H * hd). Runs ``ops.flash_attention`` (the CUDA
    kernel on the card, the reference's ``flash_attention_pallas``) on
    (b * H, s, hd) / (b * KV, t, hd) copies of the heads, all in f32 inside.

    ``lengths`` (ragged prefill) is accepted and not passed on: the kernel
    masks causally only, and for the rows that are read that is the same
    attention. A query at position p < lengths[i] sees keys <= p, all of
    them valid; the caller zeroes the pad K/V rows before attention and
    caching; and the logits are taken at lengths[i] - 1. Only the hidden
    states at pad positions differ from the reference's, and nothing reads
    them. ``use_window`` (gemma2's per-layer local/global switch) is a
    static bool or None here (the layer loop passes each layer's bool); a
    tensor raises.

    At bf16 the reference rounds its chunk scores and weights to bf16; the
    kernel and its plain version keep f32 and round the output once."""
    if isinstance(use_window, torch.Tensor):
        raise NotImplementedError(
            "a per-layer tensor use_window is not taken here; pass the layer's bool "
            "(transformer._layer_windows) or None")
    if lengths is not None and not causal:
        raise ValueError("ragged lengths need causal attention")
    if use_window is not None and not use_window:
        window = None
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    # the kernel reads dense (b*heads, len, hd) rows: q/k/v are views of the
    # fused QKV projection, so these copies are needed
    qf = q.permute(0, 2, 1, 3).reshape(b * h, s, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * kv, t, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * kv, t, hd).contiguous()
    out = ops.flash_attention(qf, kf, vf, group=h // kv, scale=_gqa_scale(cfg), causal=causal,
                              window=window, softcap=cfg.attn_logit_softcap or None)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3).reshape(b, s, h * hd)


def _flag_mask(s: int, window, use_window, device) -> torch.Tensor:
    """(s, s) additive mask; ``use_window`` selects the sliding-window
    variant per layer (gemma2's local/global alternation): a bool builds
    only the mask it selects, a bool tensor selects between both."""
    if window is None or use_window is False:
        return causal_mask(s, None, device=device)
    local = causal_mask(s, window, device=device)
    if use_window is None or use_window is True:
        return local
    return torch.where(use_window, local, causal_mask(s, None, device=device))


def _flag_decode_mask(cache_len: int, pos, window, use_window, device) -> torch.Tensor:
    if window is None or use_window is False:
        return decode_mask(cache_len, pos, None, device=device)
    local = decode_mask(cache_len, pos, window, device=device)
    if use_window is None or use_window is True:
        return local
    return torch.where(use_window, local, decode_mask(cache_len, pos, None, device=device))


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, *, window=None, use_window=None,
                causal=True) -> torch.Tensor:
    """Full-sequence self-attention (the scoring/training forward): blockwise
    (``_mha_blockwise``) under ``flags.blockwise_attention`` when s > 1,
    else ``_mha`` with the flag mask (no mask when not ``causal``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    if flags.get("blockwise_attention") and s > 1:
        ctx = _mha_blockwise(q, k, v, cfg, causal=causal, window=window,
                             use_window=use_window)
    else:
        mask = (_flag_mask(s, window, use_window, x.device) if causal
                else torch.zeros((s, s), dtype=torch.float32, device=x.device))
        ctx = _mha(q, k, v, mask, cfg)
    return linear(p["wo"], ctx)


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, cache_len: int, *, window=None,
                use_window=None, lengths: torch.Tensor | None = None):
    """Returns (y, (k_cache, v_cache)) with caches padded to cache_len: the
    base (b, T, KV, hd) layout, (b, KV, T, hd) under
    ``flags.kvt_cache_layout``, or the quantized kvt rows and scales.

    ``lengths`` (b,) marks each row's true prompt length in a right-padded
    batch: keys at positions >= lengths[i] are masked out and their K/V rows
    zeroed before caching, as in the reference (the blockwise path masks
    causally only; see ``_mha_blockwise``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :] < lengths[:, None])[..., None, None]
        k = torch.where(valid, k, 0)
        v = torch.where(valid, v, 0)
    if flags.get("blockwise_attention") and s > 1:
        ctx = _mha_blockwise(q, k, v, cfg, window=window, use_window=use_window,
                             lengths=lengths)
    else:
        mask = _flag_mask(s, window, use_window, x.device)
        if lengths is not None:
            mask = mask[None] + length_mask(lengths, s)[:, None, :]     # (b, s, s)
        ctx = _mha(q, k, v, mask, cfg)
    kvq = kv_quant_format(cfg)
    if kvq:
        # kvt-major storage rows (b, KV, T, hd) and scales (b, KV, T)
        kq, ks = _quantize_rows(k.permute(0, 2, 1, 3), kvq)
        vq, vs = _quantize_rows(v.permute(0, 2, 1, 3), kvq)
        pad, pad_s = (0, 0, 0, cache_len - s), (0, cache_len - s)
        return linear(p["wo"], ctx), (_pad_rows(kq, pad), F.pad(ks, pad_s),
                                      _pad_rows(vq, pad), F.pad(vs, pad_s))
    if flags.get("kvt_cache_layout"):
        pad = (0, 0, 0, cache_len - s)                              # (b, KV, T, hd)
        return linear(p["wo"], ctx), (F.pad(k.permute(0, 2, 1, 3), pad),
                                      F.pad(v.permute(0, 2, 1, 3), pad))
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
    mask = _flag_decode_mask(k_cache.shape[1], pos, window, use_window, x.device)
    ctx = _mha(q, k_cache, v_cache, _bcast_decode_mask(mask), cfg)  # (b, 1, q_dim)
    return linear(p["wo"], ctx[:, 0, :]), (k_cache, v_cache)


# KV-cache quantization storage dtypes (cfg.kv_quant / serve --kv-quant):
# one scale per (position, kv head) row, group = head_dim, the paper's
# group-wise symmetric scheme (Eq. 1) applied to the cache.
KV_STORE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def kv_quant_format(cfg: ModelConfig) -> str | None:
    """The active KV-cache quantization format: ``cfg.kv_quant``, or "int8"
    under the reference's older ``int8_kv_cache`` flag."""
    kvq = cfg.kv_quant or ("int8" if flags.get("int8_kv_cache") else None)
    if kvq is not None and kvq not in KV_STORE_DTYPES:
        raise ValueError(f"unknown kv_quant format {kvq!r}; supported: "
                         f"{sorted(KV_STORE_DTYPES)}")
    return kvq


def _quantize_rows(t: torch.Tensor, fmt: str = "int8"):
    """Symmetric quantization over the last axis (head_dim = one group),
    Eq. 1, bit-exact against the reference. t (..., hd) -> (storage rows,
    f32 scales (...)). int8: S = absmax * 2/255, round half to even, clip to
    +-127. fp8: S = absmax / 448, a cast onto the e4m3 grid. A zero row
    keeps scale 0 and values 0."""
    t32 = t.to(torch.float32)
    absmax = t32.abs().amax(dim=-1)
    if fmt == "fp8":
        scales = absmax / FP8_MAX
        safe = torch.where(scales > 0, scales, 1.0)
        return (t32 / safe[..., None]).to(torch.float8_e4m3fn), scales
    scales = absmax * (2.0 / 255.0)
    safe = torch.where(scales > 0, scales, 1.0)
    q = torch.clamp(torch.round(t32 / safe[..., None]), -127, 127)
    return q.to(torch.int8), scales


def _pad_rows(x: torch.Tensor, pad) -> torch.Tensor:
    """F.pad for storage rows: fp8 has no pad kernel, so pad its bytes."""
    if x.dtype == torch.float8_e4m3fn:
        return F.pad(x.view(torch.uint8), pad).view(torch.float8_e4m3fn)
    return F.pad(x, pad)


def gqa_decode_deferred_quant(p, x: torch.Tensor, cache, pos, cfg: ModelConfig, *,
                              window=None, use_window=None):
    """Quantized-KV-cache decode over the kvt layout (int8 or fp8 rows):
    scores = (q . k_q) * k_s; ctx = (attn * v_s) . v_q, the per-row scales
    factored out of the sums like the GQMV group scales. The cache is read
    only; returns (y, (k_q, k_s, v_q, v_s) rows (b, KV, 1[, hd])) for the
    caller to commit with ``commit_layers_bkt``. Plain PyTorch: the
    reference runs XLA here too, no kernel."""
    kq_c, ks_c, vq_c, vs_c = cache      # (b, KV, T, hd) storage, (b, KV, T) f32
    b = x.shape[0]
    hd, kv_heads, h = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    g = h // kv_heads
    t = kq_c.shape[2]
    q, k_new, v_new = _qkv(p, x[:, None, :], cfg, _pos_rows(pos, b, x.device))
    qg = q.reshape(b, kv_heads, g, hd)
    scores = torch.einsum("bkgh,bkth->bkgt", qg, kq_c.to(x.dtype)).to(torch.float32)
    scores = scores * ks_c[:, :, None, :]
    cur = torch.einsum("bkgh,bkh->bkg", qg, k_new[:, 0]).to(torch.float32)
    scores = _col_update(scores, cur, pos)
    scores = _scale_cap(scores, cfg)
    dm = _flag_decode_mask(t, pos, window, use_window, x.device)
    scores = scores + (dm[None, None, None, :] if dm.ndim == 1 else dm[:, None, None, :])
    attn = torch.softmax(scores, dim=-1)                            # f32 (b, KV, G, T)
    ctx = torch.einsum("bkgt,bkth->bkgh", (attn * vs_c[:, :, None, :]).to(x.dtype),
                       vq_c.to(x.dtype))
    ctx = ctx + _col_at(attn, pos).to(x.dtype) * v_new[:, 0][:, :, None, :]
    ctx = ctx.reshape(b, h * hd)
    kvq = kv_quant_format(cfg) or "int8"
    kq_n, ks_n = _quantize_rows(k_new[:, 0], kvq)                   # (b, KV, hd) / (b, KV)
    vq_n, vs_n = _quantize_rows(v_new[:, 0], kvq)
    rows = (kq_n[:, :, None, :], ks_n[:, :, None], vq_n[:, :, None, :], vs_n[:, :, None])
    return linear(p["wo"], ctx), rows


def _attend_deferred(q, k_new, v_new, cache, pos, mask: torch.Tensor, cfg: ModelConfig
                     ) -> torch.Tensor:
    """The attention of a deferred decode step: q (b, 1, H, hd) over the
    read-only float cache (``kvt_cache_layout`` picks its layout; its slot
    at ``pos`` still zero) plus the step's own rows k_new, v_new (b, 1, KV,
    hd), under the decode ``mask`` (t,) or (b, t). The current token enters
    through ``_col_update`` (its score replaces column ``pos``) and
    ``_col_at`` (its weight times its value row), as in the reference.
    Returns ctx (b, H * hd)."""
    k_cache, v_cache = cache
    b = q.shape[0]
    hd, kv_heads, h = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    g = h // kv_heads
    kvt = bool(flags.get("kvt_cache_layout"))
    qg = q.reshape(b, kv_heads, g, hd)
    if kvt:
        scores = torch.einsum("bkgh,bkth->bkgt", qg, k_cache).to(torch.float32)
    else:
        scores = torch.einsum("bkgh,btkh->bkgt", qg, k_cache).to(torch.float32)
    cur = torch.einsum("bkgh,bkh->bkg", qg, k_new[:, 0]).to(torch.float32)
    scores = _col_update(scores, cur, pos)
    scores = _scale_cap(scores, cfg)
    scores = scores + (mask[None, None, None, :] if mask.ndim == 1 else mask[:, None, None, :])
    attn = torch.softmax(scores, dim=-1).to(q.dtype)                # (b, KV, G, T)
    # the cache's slot at pos is zero, so its contribution is exactly the
    # current-token term below
    if kvt:
        ctx = torch.einsum("bkgt,bkth->bkgh", attn, v_cache)
    else:
        ctx = torch.einsum("bkgt,btkh->bkgh", attn, v_cache)
    ctx = ctx + _col_at(attn, pos) * v_new[:, 0][:, :, None, :]
    return ctx.reshape(b, h * hd)


def gqa_decode_deferred(p, x: torch.Tensor, cache, pos, cfg: ModelConfig, *, window=None,
                        use_window=None):
    """Decode WITHOUT writing the cache: attends over the read-only cache
    (whose slot at ``pos`` is still zero) plus the freshly computed K/V row
    (``_attend_deferred``), and returns that row for the caller to commit
    after the last layer (``commit_layers_bt``, or ``commit_layers_bkt`` for
    the kvt layout). Both float layouts: (b, T, KV, hd), and (b, KV, T, hd)
    under ``flags.kvt_cache_layout``. Plain PyTorch: the reference runs XLA
    here too, no kernel."""
    k_cache = cache[0]
    b = x.shape[0]
    kvt = bool(flags.get("kvt_cache_layout"))
    q, k_new, v_new = _qkv(p, x[:, None, :], cfg, _pos_rows(pos, b, x.device))
    t = k_cache.shape[2] if kvt else k_cache.shape[1]
    mask = _flag_decode_mask(t, pos, window, use_window, x.device)
    ctx = _attend_deferred(q, k_new, v_new, cache, pos, mask, cfg)
    if kvt:
        rows = (k_new[:, 0][:, :, None, :], v_new[:, 0][:, :, None, :])     # (b, KV, 1, hd)
    else:
        rows = (k_new, v_new)                                               # (b, 1, KV, hd)
    return linear(p["wo"], ctx), rows


def verify_steps(pos: torch.Tensor, k: int, t: int, block_table: torch.Tensor | None = None,
                 block_size: int | None = None, window: int | None = None):
    """The k decode steps a verify chunk starting at ``pos`` (b,) stands for,
    computed once for all layers: (positions (b, k), the chunk rows' cache
    targets, steps). A target is an index pair (i0, i1), each (b, k), into a
    layer's (b, T, ...) cache (slot row, time) or, with ``block_table``, its
    (NB, BS, ...) pool (physical block, offset; the block index clamped to
    the table width, as ``commit_layers_paged``). ``steps[m]`` is (pos + m,
    its decode masks over ``t`` slots, the target pair of column m); the
    masks are (full, local), local the ``window`` mask (None without one),
    and each layer takes its own (``_step_mask``)."""
    b = pos.shape[0]
    positions = pos.long()[:, None] + torch.arange(k, device=pos.device)[None, :]   # (b, k)
    if block_table is None:
        target = (torch.arange(b, device=pos.device)[:, None].expand(b, k), positions)
    else:
        idx = torch.clamp(positions // block_size, max=block_table.shape[1] - 1)
        target = (torch.gather(block_table.long(), 1, idx), positions % block_size)
    steps = []
    for m in range(k):
        pm = positions[:, m].contiguous()
        masks = (decode_mask(t, pm), None if window is None else decode_mask(t, pm, window))
        steps.append((pm, masks, (target[0][:, m], target[1][:, m])))
    return positions, target, steps


def _step_mask(masks, use_window) -> torch.Tensor:
    """A verify column's decode mask for a layer: the window mask where the
    layer uses the window (``use_window`` True or None, as
    ``_flag_decode_mask``), else the full one."""
    full, local = masks
    return local if local is not None and use_window is not False else full


def gqa_verify(p, x: torch.Tensor, cache, positions: torch.Tensor, steps, cfg: ModelConfig, *,
               use_window=None):
    """Speculative-verify attention over the contiguous float cache (k, v)
    each (b, T, KV, hd): x (b, k, d_model) the chunk, ``positions`` and
    ``steps`` from :func:`verify_steps`. The chunk's projections run once
    over its b·k rows (one GQMM each); chunk column m then attends as the
    decode step at pos + m does (``gqa_decode``'s ``_mha``, or
    ``_attend_deferred`` under ``deferred_decode_cache``), with the chunk's
    rows 0..m-1 in the cache. Each verify row thus sums in its decode
    step's order, so greedy verify picks vanilla decode's tokens bit for
    bit on every device. Writes the chunk's K/V rows into their slots in
    place: the caller restores them (``transformer.lm_verify``). Returns (y
    (b, k, d_model), (k_rows, v_rows) (b, k, KV, hd)) for the commit of the
    accepted prefix (``commit_layers_verify``). ``use_window`` picks each
    column's mask (``_step_mask``). Plain PyTorch, as decode."""
    k_cache, v_cache = cache
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    deferred = bool(flags.get("deferred_decode_cache"))
    ctx = []
    for m, (pm, masks, target) in enumerate(steps):
        mask = _step_mask(masks, use_window)
        qm, km, vm = (t[:, m:m + 1].contiguous() for t in (q, k_new, v_new))
        if deferred:
            ctx.append(_attend_deferred(qm, km, vm, cache, pm, mask, cfg))
        k_cache[target] = km[:, 0]
        v_cache[target] = vm[:, 0]
        if not deferred:
            ctx.append(_mha(qm, k_cache, v_cache, _bcast_decode_mask(mask), cfg)[:, 0, :])
    return linear(p["wo"], torch.stack(ctx, dim=1)), (k_new, v_new)


def gqa_verify_paged(p, x: torch.Tensor, pages, block_table: torch.Tensor,
                     positions: torch.Tensor, steps, cfg: ModelConfig, *, use_window=None):
    """Paged speculative-verify attention over one layer's float block pool
    (k_pages, v_pages) each (NB, BS, KV, hd): chunk column m runs the paged
    decode step's attention (``_attend_paged``: ``ops.paged_attention``, the
    CUDA kernel on the card) at pos + m, then its K/V rows are written into
    the pool for the columns after it. The contract of :func:`gqa_verify`;
    commit with ``commit_layers_paged_verify``."""
    k_pages, v_pages = pages
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    ctx = []
    for m, (pm, masks, target) in enumerate(steps):
        kn, vn = k_new[:, m].contiguous(), v_new[:, m].contiguous()
        ctx.append(_attend_paged(q[:, m:m + 1], kn, vn, pages, block_table, pm,
                                 _step_mask(masks, use_window), cfg))
        k_pages[target] = kn
        v_pages[target] = vn
    return linear(p["wo"], torch.stack(ctx, dim=1)), (k_new, v_new)


def _attend_paged(q, kn, vn, pages, block_table: torch.Tensor, pos: torch.Tensor,
                  mask: torch.Tensor, cfg: ModelConfig, scales=None) -> torch.Tensor:
    """The attention of a paged decode step (``kernels/ops.paged_attention``:
    the CUDA kernel on the card): q (b, 1, H, hd) over the block pool
    through each row's block table, the current token's rows kn, vn (b, KV,
    hd) handled explicitly so the pool is read only; ``mask`` (b, t).
    Returns ctx (b, H * hd)."""
    k_pages, v_pages = pages
    b = q.shape[0]
    hd, kv_heads = cfg.resolved_head_dim, cfg.num_kv_heads
    g = cfg.num_heads // kv_heads
    k_scales, v_scales = scales if scales is not None else (None, None)
    # the kernel takes contiguous rows; q is a view of the fused QKV
    # projection
    qg = q.reshape(b, kv_heads, g, hd).contiguous()
    return ops.paged_attention(
        qg, k_pages, v_pages, block_table, pos, kn, vn, mask,
        scale=_gqa_scale(cfg), softcap=cfg.attn_logit_softcap or None,
        k_scales=k_scales, v_scales=v_scales)


def gqa_decode_paged(p, x: torch.Tensor, pages, block_table: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, window=None, use_window=None, scales=None):
    """Paged decode step: attention over one layer's block pool through each
    row's block table (``_attend_paged``), the current token handled
    explicitly so the pool is read only. x (b, d_model); pages (k_pages,
    v_pages) each (NB, BS, KV, hd); block_table (b, MB); pos (b,) virtual
    positions. With cfg.kv_quant the pool rows are int8/fp8 and ``scales``
    is (k_scales, v_scales), each (NB, BS, KV). Returns (y, rows): (k_new,
    v_new) (b, KV, hd), or the quantized (k_q, k_s, v_q, v_s), for
    ``commit_layers_paged``."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x[:, None, :], cfg, _pos_rows(pos, b, x.device))
    t = block_table.shape[1] * pages[0].shape[1]
    # the kernel takes contiguous rows; k_new and v_new are views of the
    # fused QKV projection
    kn, vn = k_new[:, 0].contiguous(), v_new[:, 0].contiguous()
    mask = _flag_decode_mask(t, pos, window, use_window, x.device)     # (b, t)
    ctx = _attend_paged(q, kn, vn, pages, block_table, pos, mask, cfg, scales)
    kvq = cfg.kv_quant
    if kvq:
        kq, ks = _quantize_rows(kn, kvq)                            # (b, KV, hd) / (b, KV)
        vq, vs = _quantize_rows(vn, kvq)
        return linear(p["wo"], ctx), (kq, ks, vq, vs)
    return linear(p["wo"], ctx), (kn, vn)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention: minicpm3, deepseek-v2-lite)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The reference's MLA tree: the fused latent + rope-key projection
    ``wdkv``, ``kv_norm``, the latent up-projection ``wukv``, ``wo``, and
    the query projection ``wq``, or with ``q_lora_rank`` its low-rank pair
    ``wdq`` / ``q_norm`` / ``wuq``."""
    m = cfg.mla
    dt, d, h = cfg.pdtype(), cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    dev = gen.device
    p = {
        "wdkv": dense_init(gen, m.kv_lora_rank + m.qk_rope_dim, d, dt, lead),
        "kv_norm": torch.ones((*lead, m.kv_lora_rank), dtype=dt, device=dev),
        "wukv": dense_init(gen, h * (m.qk_nope_dim + m.v_head_dim), m.kv_lora_rank, dt, lead),
        "wo": dense_init(gen, d, h * m.v_head_dim, dt, lead),
    }
    if m.q_lora_rank:
        p["wdq"] = dense_init(gen, m.q_lora_rank, d, dt, lead)
        p["q_norm"] = torch.ones((*lead, m.q_lora_rank), dtype=dt, device=dev)
        p["wuq"] = dense_init(gen, h * qk_dim, m.q_lora_rank, dt, lead)
    else:
        p["wq"] = dense_init(gen, h * qk_dim, d, dt, lead)
    return p


def _mla_q(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    m = cfg.mla
    b, s, _ = x.shape
    if m.q_lora_rank:
        q = linear(p["wuq"], rmsnorm(linear(p["wdq"], x), p["q_norm"], cfg.norm_eps))
    else:
        q = linear(p["wq"], x)
    q = q.reshape(b, s, cfg.num_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(normed latent c_kv (b, s, kv_lora_rank), RoPE'd shared key k_rope
    (b, s, qk_rope_dim)) from the fused ``wdkv`` projection."""
    m = cfg.mla
    c = linear(p["wdkv"], x)
    c_kv, k_rope = c[..., : m.kv_lora_rank], c[..., m.kv_lora_rank:]
    c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_scale(m) -> float:
    return (m.qk_nope_dim + m.qk_rope_dim) ** -0.5


def _mla_attend(p, x: torch.Tensor, cfg: ModelConfig, q, latent, *, window=None,
                lengths=None) -> torch.Tensor:
    """The reference's ``mla_forward`` after its projections: K/V
    materialized from the latent through ``wukv`` (a GQMM with quantized
    weights), causal scores as the sum of the no-RoPE and RoPE einsums in
    x's dtype, then f32 and the scale; ``lengths`` masks right-pad keys."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = q
    c_kv, k_rope = latent
    kv = linear(p["wukv"], c_kv).reshape(b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., : m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, k_rope)).to(torch.float32)
    scores = scores * _mla_scale(m)
    mask = causal_mask(s, window, device=x.device)
    if lengths is not None:
        mask = (mask[None] + length_mask(lengths, s)[:, None, :])[:, None]   # (b, 1, s, s)
    attn = torch.softmax(scores + mask, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,bthd->bshd", attn, v).reshape(b, s, h * m.v_head_dim)
    return linear(p["wo"], ctx)


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, *, window=None,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Naive (materialized) MLA for scoring and prefill. ``lengths`` (b,)
    masks right-pad keys per row (ragged prefill)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _mla_attend(p, x, cfg, _mla_q(p, x, cfg, positions),
                       _mla_latent(p, x, cfg, positions), window=window, lengths=lengths)


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, cache_len: int, *, window=None,
                lengths: torch.Tensor | None = None):
    """Returns (y, (c_kv, k_rope)) with the latent cache rows padded to
    ``cache_len`` (MLA's memory saving: the cache holds the low-rank latent,
    not K/V). ``lengths`` (b,): pad keys masked and their latent rows
    zeroed, as in ``gqa_prefill``. The reference computes the latent twice
    (in ``mla_forward`` and again for the cache); here once, the same
    values."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    y = _mla_attend(p, x, cfg, q, (c_kv, k_rope), window=window, lengths=lengths)
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :] < lengths[:, None])[..., None]
        c_kv = torch.where(valid, c_kv, 0)
        k_rope = torch.where(valid, k_rope, 0)
    pad = (0, 0, 0, cache_len - s)
    return y, (F.pad(c_kv, pad), F.pad(k_rope, pad))


def _maybe_dequant(w) -> torch.Tensor:
    """A quantized weight dequantized to f32 (``dequantize()``'s default), as
    the reference's decode takes ``wukv``; a float weight as it is."""
    return dequantize_unchecked(w) if isinstance(w, QuantizedTensor) else w


def _mla_absorbed(p, x: torch.Tensor, cfg: ModelConfig, pos):
    """A decode step's absorbed query: (q_abs (b, H, kv_lora_rank), q_rope
    (b, H, rope), the step's latent rows (c_new, r_new) each (b, 1, .), and
    ``wuv`` (H, v, kv_lora_rank) in x's dtype). ``wukv`` is dequantized,
    never a GQMM."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    positions = _pos_rows(pos, b, x.device)
    q_nope, q_rope = _mla_q(p, x[:, None, :], cfg, positions)
    c_new, r_new = _mla_latent(p, x[:, None, :], cfg, positions)
    wukv = _maybe_dequant(p["wukv"]).reshape(h, m.qk_nope_dim + m.v_head_dim, m.kv_lora_rank)
    wuk, wuv = wukv[:, : m.qk_nope_dim, :], wukv[:, m.qk_nope_dim:, :]
    q_abs = torch.einsum("bhd,hdc->bhc", q_nope[:, 0], wuk.to(x.dtype))
    return q_abs, q_rope[:, 0], (c_new, r_new), wuv.to(x.dtype)


def mla_decode_deferred(p, x: torch.Tensor, cache, pos, cfg: ModelConfig, *, window=None):
    """Absorbed MLA decode WITHOUT writing the latent cache: attends over the
    read-only cache (slot ``pos`` still zero) plus the current latent row
    (``_col_update`` / ``_col_at``, as ``_attend_deferred``) and returns
    (y, (c_new, r_new) (b, 1, .)) for one commit a leaf after the last
    layer (``commit_layers_bt``)."""
    m = cfg.mla
    b = x.shape[0]
    c_cache, r_cache = cache                        # (b, T, kvr) / (b, T, rope)
    t = c_cache.shape[1]
    q_abs, q_rope, (c_new, r_new), wuv = _mla_absorbed(p, x, cfg, pos)
    scores = (torch.einsum("bhc,btc->bht", q_abs, c_cache)
              + torch.einsum("bhd,btd->bht", q_rope, r_cache)).to(torch.float32)
    cur = (torch.einsum("bhc,bc->bh", q_abs, c_new[:, 0])
           + torch.einsum("bhd,bd->bh", q_rope, r_new[:, 0])).to(torch.float32)
    scores = _col_update(scores, cur, pos)
    dm = decode_mask(t, pos, window, device=x.device)
    scores = scores * _mla_scale(m) + _bcast_decode_mask(dm)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    # the cache's slot at pos is zero: its contribution is the explicit term
    ctx = torch.einsum("bht,btc->bhc", attn, c_cache)
    ctx = ctx + _col_at(attn, pos) * c_new[:, 0][:, None, :]
    out = torch.einsum("bhc,hvc->bhv", ctx, wuv).reshape(b, cfg.num_heads * m.v_head_dim)
    return linear(p["wo"], out), (c_new, r_new)


def mla_decode(p, x: torch.Tensor, cache, pos, cfg: ModelConfig, *, window=None):
    """Absorbed-matrix decode: writes the step's latent rows into the cache
    (in place), then attends directly over the latent cache without
    materializing per-position K/V. Returns (y, (c_cache, r_cache))."""
    m = cfg.mla
    b = x.shape[0]
    c_cache, r_cache = cache                        # (b, T, kvr) / (b, T, rope)
    q_abs, q_rope, (c_kv, k_rope), wuv = _mla_absorbed(p, x, cfg, pos)
    c_cache = _commit_bt(c_cache, c_kv, pos)
    r_cache = _commit_bt(r_cache, k_rope, pos)
    scores = (torch.einsum("bhc,btc->bht", q_abs, c_cache)
              + torch.einsum("bhd,btd->bht", q_rope, r_cache)).to(torch.float32)
    scores = scores * _mla_scale(m)
    dm = decode_mask(c_cache.shape[1], pos, window, device=x.device)
    attn = torch.softmax(scores + _bcast_decode_mask(dm), dim=-1).to(x.dtype)
    ctx = torch.einsum("bht,btc->bhc", attn, c_cache)
    out = torch.einsum("bhc,hvc->bhv", ctx, wuv).reshape(b, cfg.num_heads * m.v_head_dim)
    return linear(p["wo"], out), (c_cache, r_cache)
