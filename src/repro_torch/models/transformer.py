"""Decoder-only transformer LM (counterpart of ``repro/models/transformer.py``),
the dense GQA path of TinyLlama.

Parameters keep the reference's tree: stacked (L, ...) layer leaves under
the same keys, so a reference checkpoint crosses through ``bridge.py``
unchanged. The reference scans over layers; here a Python loop takes one
layer's views out of the stacked leaves at a time. The KV cache is the base
(L, b, T, KV, hd) layout and decode writes it in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import embedding_lookup, linear
from repro_torch.core.tree import tree_index
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpmod
from repro_torch.models.common import dense_init, embed_init, rmsnorm


def _check_ported(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("mla", cfg.mla), ("moe", cfg.moe), ("gemma_norms", cfg.gemma_norms),
        ("sliding_window", cfg.sliding_window), ("kv_quant", cfg.kv_quant),
        ("attn_logit_softcap", cfg.attn_logit_softcap),
        ("final_logit_softcap", cfg.final_logit_softcap),
        ("frontend", cfg.frontend)) if on]
    if cfg.model_type != "decoder_lm" or unported:
        raise NotImplementedError(
            f"{cfg.arch_id}: {cfg.model_type} with {unported} is not yet ported "
            "to repro_torch (dense GQA decoder_lm only)")


def init_lm(cfg: ModelConfig, device="cuda", *, seed: int = 0) -> dict:
    """Random parameters in the reference's tree layout, drawn from an
    explicit ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from the reference's ``jax.random`` ones; use
    ``bridge.init_params_numpy`` for weights both packages share)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, d, L = cfg.pdtype(), cfg.d_model, cfg.num_layers
    params = {
        "embed": embed_init(gen, cfg.vocab_padded, d, dt),
        "layers": {
            "att_norm": torch.ones((L, d), dtype=dt, device=dev),
            "attn": attn.init_gqa(gen, cfg, lead=(L,)),
            "ffn_norm": torch.ones((L, d), dtype=dt, device=dev),
            "mlp": mlpmod.init_mlp(gen, cfg, lead=(L,)),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["classifier"] = dense_init(gen, cfg.vocab_padded, d, dt)
    return params


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return embedding_lookup(params["embed"], tokens, cfg.cdtype())


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"] if cfg.tie_embeddings else params["classifier"]
    return linear(w, x)


def _block(lp, x: torch.Tensor, cfg: ModelConfig, attn_fn) -> torch.Tensor:
    """One residual block given an attention closure; shared by all paths."""
    x = x + attn_fn(rmsnorm(x, lp["att_norm"], cfg.norm_eps))
    return x + mlpmod.mlp_forward(lp["mlp"], rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int,
               lengths: torch.Tensor | None = None):
    """Prompt pass: returns (last-position logits, populated cache).

    ``lengths`` (b,) enables ragged right-padded prompts: pad keys are
    masked (their cached K/V rows zeroed) and row i's logits are taken at
    position lengths[i]-1."""
    _check_ported(cfg)
    x = _embed(params, tokens, cfg)
    b = x.shape[0]
    cache = lm_init_cache(cfg, b, cache_len, x.dtype, x.device)
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)

        def attn_fn(h, lp=lp, i=i):
            y, (k, v) = attn.gqa_prefill(lp["attn"], h, cfg, cache_len, lengths=lengths)
            cache["k"][i] = k
            cache["v"][i] = v
            return y

        x = _block(lp, x, cfg, attn_fn)
    if lengths is None:
        last = x[:, -1, :]
    else:
        last = x[torch.arange(b, device=x.device), lengths - 1]
    return _logits(params, last, cfg), cache


def lm_decode(params, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig):
    """One decode step. token (b,); pos an int or (b,) per-request positions.
    Returns (logits (b, vocab_padded), cache); the cache is updated in place."""
    _check_ported(cfg)
    x = embedding_lookup(params["embed"], token, cfg.cdtype())
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)

        def attn_fn(h, lp=lp, i=i):
            y, _ = attn.gqa_decode(lp["attn"], h, (cache["k"][i], cache["v"][i]), pos, cfg)
            return y

        x = _block(lp, x, cfg, attn_fn)
    return _logits(params, x, cfg), cache
