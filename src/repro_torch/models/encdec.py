"""Encoder-decoder backbone of seamless-m4t-large-v2 (counterpart of
``repro/models/encdec.py``).

The speech frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings ``batch["frames"]`` (b, s_enc, d_model). The
backbone is a plain transformer encoder-decoder: a bidirectional encoder
(``attn.gqa_forward(causal=False)``: the flash kernel with ``causal=False``
under ``flags.blockwise_attention``) and a decoder with causal self
attention and cross attention to the encoder's output. Every projection
goes through ``linear``, so the quantized weights run the GQMM kernels in
the encoder, the decoder's self and cross attention and the FFNs alike.
Cross attention has no kernel in the reference (its ``_mha`` under a zero
mask, whatever the flags): here too it is plain PyTorch.

Parameters keep the reference's tree: stacked (L, ...) leaves under
``enc_layers`` and ``dec_layers`` (the cross attention's ``wkv`` fused).
The reference scans over the layers; here a Python loop takes one layer's
views at a time. The serving cache is the reference's dict: the decoder's
self K/V ``k``/``v`` (L, b, T, KV, hd) and the cross K/V ``cross_k``/
``cross_v`` (L, b, s_enc, KV, hd), computed once by prefill; decode writes
the self K/V in place and reads the cross K/V. Cross attention attends to
every memory row under a zero mask, so the cross cache must hold exactly
the encoder's rows: a captured prefill's static cache is allocated with
``memory_len`` equal to the frames' length.

What the reference cannot run is refused loudly: its prefill fails under
``flags.kvt_cache_layout`` (its decode cannot read the kvt self cache) and
under a quantized KV cache (it unpacks two of ``gqa_prefill``'s four
leaves), and it has no ragged lengths.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import flags
from repro_torch.core.qlinear import embedding_lookup, linear, split_fused
from repro_torch.core.tree import tree_index
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpmod
from repro_torch.models.common import dense_init, embed_init, remat_call, rmsnorm

# cross-attention encoder-memory length of the reference's decode-shape specs
DEFAULT_MEMORY_LEN = 4096


def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    dt = cfg.pdtype()
    return {"wq": dense_init(gen, cfg.q_dim, cfg.d_model, dt, lead),
            "wkv": dense_init(gen, 2 * cfg.kv_dim, cfg.d_model, dt, lead),   # fused (C4)
            "wo": dense_init(gen, cfg.d_model, cfg.q_dim, dt, lead)}


def cross_kv(p, memory: torch.Tensor, cfg: ModelConfig):
    """Cross K/V (b, t, KV, hd) each from the encoder output (b, t, d),
    computed once a request."""
    b, t, _ = memory.shape
    hd = cfg.resolved_head_dim
    k, v = split_fused(linear(p["wkv"], memory), (cfg.kv_dim, cfg.kv_dim))
    return (k.reshape(b, t, cfg.num_kv_heads, hd), v.reshape(b, t, cfg.num_kv_heads, hd))


def cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 memory_mask: torch.Tensor | None = None) -> torch.Tensor:
    """x (b, s, d), the decoder stream, attending to the encoder memory's
    K/V (b, t, KV, hd): the plain ``_mha`` under a zero mask (or
    ``memory_mask``), as the reference does under every flag."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, hd)
    mask = (torch.zeros((s, k.shape[1]), dtype=torch.float32, device=x.device)
            if memory_mask is None else memory_mask)
    return linear(p["wo"], attn._mha(q, k, v, mask, cfg))


def init_encdec(cfg: ModelConfig, device="cuda", *, seed: int = 0) -> dict:
    """Random parameters in the reference's tree from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (``bridge.init_params_numpy`` gives
    both packages the same ones)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, d = cfg.pdtype(), cfg.d_model
    le, ld = (cfg.encoder_layers,), (cfg.num_layers,)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params = {"embed": embed_init(gen, cfg.vocab_padded, d, dt),
              "enc_layers": {"att_norm": ones(*le, d), "attn": attn.init_gqa(gen, cfg, le),
                             "ffn_norm": ones(*le, d), "mlp": mlpmod.init_mlp(gen, cfg, lead=le)}}
    params["enc_norm"] = ones(d)
    params["dec_layers"] = {"att_norm": ones(*ld, d), "attn": attn.init_gqa(gen, cfg, ld),
                            "cross_norm": ones(*ld, d), "cross": init_cross_attn(gen, cfg, ld),
                            "ffn_norm": ones(*ld, d), "mlp": mlpmod.init_mlp(gen, cfg, lead=ld)}
    params["final_norm"] = ones(d)
    params["classifier"] = dense_init(gen, cfg.vocab_padded, d, dt)
    return params


def _frames(batch) -> torch.Tensor:
    frames = batch.get("frames")
    if frames is None:
        raise KeyError("frames: the encoder-decoder needs batch['frames'] (b, s_enc, d_model), "
                       "the speech frontend's frame embeddings")
    return frames


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *, remat: bool = True
           ) -> torch.Tensor:
    """frames (b, s_enc, d_model) -> the encoder memory (b, s_enc, d_model):
    bidirectional self attention. ``remat`` with grad enabled recomputes
    each layer in the backward (``common.remat_call``), as the
    reference's ``jax.checkpoint``."""
    def layer(x, lp):
        x = x + attn.gqa_forward(lp["attn"], rmsnorm(x, lp["att_norm"], cfg.norm_eps), cfg,
                                 causal=False)
        return x + mlpmod.mlp_forward(lp["mlp"], rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))

    x = frames.to(cfg.cdtype())
    for i in range(cfg.encoder_layers):
        lp = tree_index(params["enc_layers"], i)
        x = remat_call(lambda x, lp=lp: layer(x, lp), x, remat)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _cross_ffn(lp, x: torch.Tensor, cfg: ModelConfig, k, v) -> torch.Tensor:
    """A decoder layer after its self attention: cross attention to the
    memory's K/V (a decode step's (b, d) rows as a (b, 1, d) sequence, the
    reference's ``h[:, None, :]``), then the FFN."""
    h = rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
    if x.ndim == 2:
        x = x + cross_attend(lp["cross"], h[:, None, :], k, v, cfg)[:, 0, :]
    else:
        x = x + cross_attend(lp["cross"], h, k, v, cfg)
    return x + mlpmod.mlp_forward(lp["mlp"], rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return linear(params["classifier"], rmsnorm(x, params["final_norm"], cfg.norm_eps))


def decode_train(params, tokens: torch.Tensor, memory: torch.Tensor, cfg: ModelConfig, *,
                 remat: bool = True) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens (b, s_dec), memory (b, t, d) ->
    logits (b, s_dec, vocab_padded); ``remat`` as in :func:`encode`."""
    def layer(x, lp):
        x = x + attn.gqa_forward(lp["attn"], rmsnorm(x, lp["att_norm"], cfg.norm_eps), cfg)
        return _cross_ffn(lp, x, cfg, *cross_kv(lp["cross"], memory, cfg))

    x = embedding_lookup(params["embed"], tokens, cfg.cdtype())
    for i in range(cfg.num_layers):
        lp = tree_index(params["dec_layers"], i)
        x = remat_call(lambda x, lp=lp: layer(x, lp), x, remat)
    return _logits(params, x, cfg)


def encdec_forward(params, batch, cfg: ModelConfig, *, remat: bool = True) -> torch.Tensor:
    """The scoring forward (``Model.forward``): ``batch["frames"]`` and the
    decoder's ``batch["tokens"]`` -> logits (b, s_dec, vocab_padded)."""
    memory = encode(params, _frames(batch), cfg, remat=remat)
    return decode_train(params, batch["tokens"], memory, cfg, remat=remat)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def encdec_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device,
                      memory_len: int = DEFAULT_MEMORY_LEN) -> dict:
    """The reference's cache: self K/V (L, b, cache_len, KV, hd) and cross
    K/V (L, b, memory_len, KV, hd). A cache that prefill writes must have
    ``memory_len`` equal to the frames' length (module docstring)."""
    hd, L, kv = cfg.resolved_head_dim, cfg.num_layers, cfg.num_kv_heads
    out = {}
    for name, t in (("k", cache_len), ("v", cache_len), ("cross_k", memory_len),
                    ("cross_v", memory_len)):
        out[name] = torch.zeros((L, batch, t, kv, hd), dtype=dtype, device=device)
    return out


def _check_cache_flags(cfg: ModelConfig) -> None:
    """Refuse the KV-cache variants the reference's encdec cannot run."""
    if attn.kv_quant_format(cfg):
        raise NotImplementedError(
            f"{cfg.arch_id}: the encoder-decoder keeps a float KV cache; under a quantized "
            "KV cache (int8_kv_cache / kv_quant) the reference's encdec_prefill fails "
            "(ValueError: too many values to unpack: gqa_prefill returns four cache leaves "
            "where it unpacks two)")
    if flags.get("kvt_cache_layout"):
        raise NotImplementedError(
            f"{cfg.arch_id}: the encoder-decoder keeps the base (b, T, KV, hd) self cache; "
            "under kvt_cache_layout the reference's encdec_prefill writes the kvt layout "
            "that its encdec_decode (the plain gqa_decode) cannot read (TypeError: cannot "
            "reshape)")


def encdec_prefill(params, batch, cfg: ModelConfig, cache_len: int, cache: dict | None = None):
    """Encode ``batch["frames"]``, compute each layer's cross K/V, and run the
    decoder prompt ``batch["tokens"]`` (b, s_dec) through ``gqa_prefill``
    into the self cache. Returns (last-position logits, cache). ``cache``,
    an ``encdec_init_cache`` tree of this batch, ``cache_len`` and a
    ``memory_len`` of s_enc, is written in place instead of a new one (a
    captured prefill's static cache)."""
    _check_cache_flags(cfg)
    if batch.get("lengths") is not None:
        raise ValueError(f"{cfg.arch_id}: model family does not support ragged lengths; "
                         "batch by exact length instead (see serving/batching.py)")
    memory = encode(params, _frames(batch), cfg, remat=False)
    x = embedding_lookup(params["embed"], batch["tokens"], cfg.cdtype())
    b, s_enc = memory.shape[:2]
    if cache is None:
        cache = encdec_init_cache(cfg, b, cache_len, x.dtype, x.device, memory_len=s_enc)
    elif cache["cross_k"].shape[2] != s_enc:
        raise ValueError(
            f"{cfg.arch_id}: the cross cache holds {cache['cross_k'].shape[2]} memory rows for "
            f"{s_enc} frames; cross attention attends to every row, so they must be equal")
    for i in range(cfg.num_layers):
        lp = tree_index(params["dec_layers"], i)
        y, (k, v) = attn.gqa_prefill(lp["attn"], rmsnorm(x, lp["att_norm"], cfg.norm_eps), cfg,
                                     cache_len)
        x = x + y
        ck, cv = cross_kv(lp["cross"], memory, cfg)
        for name, leaf in (("k", k), ("v", v), ("cross_k", ck), ("cross_v", cv)):
            cache[name][i] = leaf
        x = _cross_ffn(lp, x, cfg, ck, cv)
    return _logits(params, x[:, -1, :], cfg), cache


def encdec_decode(params, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig):
    """One decoder step: token (b,), pos an int or (b,) positions. Each
    layer writes its self K/V row in place (the plain ``gqa_decode``, as in
    the reference, whatever the decode-cache flags) and attends to the
    cross K/V as they are. Returns (logits (b, vocab_padded), cache)."""
    x = embedding_lookup(params["embed"], token, cfg.cdtype())
    for i in range(cfg.num_layers):
        lp = tree_index(params["dec_layers"], i)
        y, _ = attn.gqa_decode(lp["attn"], rmsnorm(x, lp["att_norm"], cfg.norm_eps),
                               (cache["k"][i], cache["v"][i]), pos, cfg)
        x = x + y
        x = _cross_ffn(lp, x, cfg, cache["cross_k"][i], cache["cross_v"][i])
    return _logits(params, x, cfg), cache
