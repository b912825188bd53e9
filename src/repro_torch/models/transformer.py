"""Decoder-only transformer LM (counterpart of ``repro/models/transformer.py``):
the dense GQA families TinyLlama, internlm2, deepseek-coder, pixtral's
backbone (its patch embeddings replace the first positions) and gemma2
(``plus_one`` norms with post-attention and post-FFN norms, the ×√d
embedding, sliding-window layers, attention and final soft caps); dbrx
(GQA with a MoE FFN); and the MLA families minicpm3 (dense FFN) and
deepseek-v2-lite (MoE with shared experts), whose cache is the latent
{ckv, krope} pair, contiguous only (no paged pool, no verify).

Parameters keep the reference's tree: stacked (L, ...) layer leaves under
the same keys, so a reference checkpoint crosses through ``bridge.py``
unchanged. The reference scans over layers; here a Python loop takes one
layer's views out of the stacked leaves at a time, and gemma2's
local/global switch is each layer's static bool (``_layer_windows``), so a
captured step has each layer's mask baked in. The caches are the
reference's layouts: the contiguous base (L, b, T, KV, hd) cache, the kvt
(L, b, KV, T, hd) cache (``flags.kvt_cache_layout``), its quantized variant
(``cfg.kv_quant`` or ``flags.int8_kv_cache``), and the paged block pool
(float or quantized). Decode writes them in place. ``lm_forward`` is the
scoring and training forward (``Model.forward``);
``flags.blockwise_attention`` sends its attention and prefill's through the
flash kernel (its backward kernel too in a train step). ``lm_verify`` /
``lm_verify_paged`` run a speculative k-token chunk as k decode steps'
arithmetic and leave the cache as they found it, and
``lm_commit_verify(_paged)`` commit its accepted prefix.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import flags
from repro_torch.core.qlinear import embedding_lookup, linear
from repro_torch.core.tree import tree_index
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpmod
from repro_torch.models.common import (
    dense_init,
    embed_init,
    remat_call,
    rmsnorm,
    rmsnorm_steps,
    softcap,
)

# the frontend stubs whose embeddings the decoder takes (pixtral's)
PORTED_FRONTENDS = (None, "patch_embed")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.model_type != "decoder_lm" or cfg.frontend not in PORTED_FRONTENDS:
        raise NotImplementedError(
            f"{cfg.arch_id}: {cfg.model_type} with frontend {cfg.frontend!r} is not ported to "
            f"this module (decoder_lm with frontends {PORTED_FRONTENDS} only; the 'frames' "
            "frontend is the encoder-decoder's, models/encdec.py)")


def _layer_windows(cfg: ModelConfig) -> list[bool]:
    """One bool a layer: True where the layer uses the sliding window
    (gemma2's 'L' layers of ``layer_pattern``). A Python list, so each
    layer's mask is fixed when the step is built."""
    if not cfg.layer_pattern or not cfg.sliding_window:
        return [False] * cfg.num_layers
    pat = (cfg.layer_pattern * cfg.num_layers)[: cfg.num_layers]
    return [c == "L" for c in pat]


def _window_kw(cfg: ModelConfig) -> list[dict]:
    """Each layer's attention keywords: the config's window and the layer's
    ``use_window``."""
    return [{"window": cfg.sliding_window, "use_window": w} for w in _layer_windows(cfg)]


def init_lm(cfg: ModelConfig, device="cuda", *, seed: int = 0) -> dict:
    """Random parameters in the reference's tree layout, drawn from an
    explicit ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from the reference's ``jax.random`` ones; use
    ``bridge.init_params_numpy`` for weights both packages share)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, d, L = cfg.pdtype(), cfg.d_model, cfg.num_layers
    # gemma2's norms store w - 1: zeros
    norm = torch.zeros if cfg.gemma_norms else torch.ones
    params = {
        "embed": embed_init(gen, cfg.vocab_padded, d, dt),
        "layers": {
            "att_norm": norm((L, d), dtype=dt, device=dev),
            "attn": (attn.init_mla if cfg.mla else attn.init_gqa)(gen, cfg, lead=(L,)),
            "ffn_norm": norm((L, d), dtype=dt, device=dev),
            "mlp": (mlpmod.init_moe(gen, cfg, lead=(L,)) if cfg.moe
                    else mlpmod.init_mlp(gen, cfg, lead=(L,))),
        },
        "final_norm": norm((d,), dtype=dt, device=dev),
    }
    if cfg.gemma_norms:
        params["layers"]["post_att_norm"] = torch.zeros((L, d), dtype=dt, device=dev)
        params["layers"]["post_ffn_norm"] = torch.zeros((L, d), dtype=dt, device=dev)
    if not cfg.tie_embeddings:
        params["classifier"] = dense_init(gen, cfg.vocab_padded, d, dt)
    return params


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           frontend_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings (× √d for gemma2, in the compute dtype); pixtral's
    precomputed patch embeddings (b, P, d) replace the first P positions."""
    x = embedding_lookup(params["embed"], tokens, cfg.cdtype())
    if cfg.gemma_norms:
        # √d rounded to the compute dtype first, as the reference does
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    if frontend_embeds is not None:
        pfx = frontend_embeds.to(x.dtype)
        x = torch.cat([pfx, x[:, pfx.shape[1]:, :]], dim=1)
    return x


def _logits(params, x: torch.Tensor, cfg: ModelConfig, norm=rmsnorm) -> torch.Tensor:
    x = norm(x, params["final_norm"], cfg.norm_eps, plus_one=cfg.gemma_norms)
    w = params["embed"] if cfg.tie_embeddings else params["classifier"]
    logits = linear(w, x)
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _ffn(p, h: torch.Tensor, cfg: ModelConfig, by_column: bool = False) -> torch.Tensor:
    """The layer's FFN: the MoE where ``cfg.moe`` (a decode step's (b, d)
    rows as a (b, 1, d) sequence, the reference's ``h[:, None, :]``), else
    the dense SwiGLU."""
    if not cfg.moe:
        return mlpmod.mlp_forward(p, h)
    if h.ndim == 2:
        return mlpmod.moe_forward(p, h[:, None, :], cfg)[:, 0, :]
    return mlpmod.moe_forward(p, h, cfg, by_column=by_column)


def _block(lp, x: torch.Tensor, cfg: ModelConfig, attn_fn, norm=rmsnorm) -> torch.Tensor:
    """One residual block given an attention closure; shared by all paths
    (verify passes ``rmsnorm_steps``, and its MoE router then takes each
    chunk column apart). gemma2 normalises the attention and FFN outputs
    too (``post_att_norm`` / ``post_ffn_norm``)."""
    g = cfg.gemma_norms
    a = attn_fn(norm(x, lp["att_norm"], cfg.norm_eps, plus_one=g))
    if g:
        a = norm(a, lp["post_att_norm"], cfg.norm_eps, plus_one=True)
    x = x + a
    f = _ffn(lp["mlp"], norm(x, lp["ffn_norm"], cfg.norm_eps, plus_one=g), cfg,
             by_column=norm is rmsnorm_steps)
    if g:
        f = norm(f, lp["post_ffn_norm"], cfg.norm_eps, plus_one=True)
    return x + f


# ---------------------------------------------------------------------------
# training / scoring forward
# ---------------------------------------------------------------------------

def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
               frontend_embeds: torch.Tensor | None = None, *, remat: bool = True
               ) -> torch.Tensor:
    """tokens (b, s) -> logits (b, s, vocab_padded). The training forward
    too: with ``remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    layer's input and recomputes the layer in the backward, as the
    reference's ``jax.checkpoint(body)`` does; with grad off ``remat``
    changes nothing."""
    _check_ported(cfg)
    x = _embed(params, tokens, cfg, frontend_embeds)
    for i, wkw in enumerate(_window_kw(cfg)):
        lp = tree_index(params["layers"], i)
        if cfg.mla:
            def attn_fn(h, lp=lp):
                return attn.mla_forward(lp["attn"], h, cfg)
        else:
            def attn_fn(h, lp=lp, wkw=wkw):
                return attn.gqa_forward(lp["attn"], h, cfg, **wkw)
        x = remat_call(lambda x, lp=lp, attn_fn=attn_fn: _block(lp, x, cfg, attn_fn), x, remat)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    """The contiguous KV cache: base (L, b, T, KV, hd) leaves ``k``/``v``,
    (L, b, KV, T, hd) under ``flags.kvt_cache_layout``, or with a quantized
    KV format the kvt-major storage rows ``k_q``/``v_q`` (L, b, KV, T, hd)
    and their f32 scales ``k_s``/``v_s`` (L, b, KV, T). An MLA config's is
    the latent cache, whatever the flags: ``ckv`` (L, b, T, kv_lora_rank)
    and ``krope`` (L, b, T, qk_rope_dim)."""
    if cfg.mla:
        return {"ckv": torch.zeros((cfg.num_layers, batch, cache_len, cfg.mla.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros((cfg.num_layers, batch, cache_len, cfg.mla.qk_rope_dim),
                                     dtype=dtype, device=device)}
    hd = cfg.resolved_head_dim
    kvq = attn.kv_quant_format(cfg)
    if kvq:
        sdt = attn.KV_STORE_DTYPES[kvq]
        qshape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len, hd)
        sshape = qshape[:-1]
        return {"k_q": torch.zeros(qshape, dtype=sdt, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_q": torch.zeros(qshape, dtype=sdt, device=device),
                "v_s": torch.zeros(sshape, dtype=torch.float32, device=device)}
    if flags.get("kvt_cache_layout"):
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, cache_len, hd)
    else:
        shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_insert_slots(cache: dict, rows: dict, slots: torch.Tensor) -> dict:
    """Scatter per-request prefill cache ``rows`` into decode ``slots`` of a
    batched contiguous cache, in place. Every cache layout keeps batch on
    axis 1 of each (L, b, ...) leaf, so one axis-1 scatter covers them all
    (the serving core's slot-admission contract, serving/core.py)."""
    for name, big in cache.items():
        big[:, slots] = rows[name]
    return cache


def lm_gather_slots(cache: dict, slots: torch.Tensor) -> dict:
    """Inverse of ``lm_insert_slots``: the per-slot cache rows for ``slots``."""
    return {name: big[:, slots] for name, big in cache.items()}


def lm_init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, dtype,
                        device) -> dict:
    """Block-pool KV cache: (L, NB, BS, KV, hd) leaves ``k_pages``/``v_pages``;
    with cfg.kv_quant the pages hold int8/fp8 rows and ``k_scales``/
    ``v_scales`` (L, NB, BS, KV) their f32 scales. Block 0 is the
    allocator's write-off sink (serving/paged.py); blocks are recycled
    without zeroing, since paged attention never reads an unmasked stale
    slot. The MLA latent cache has no pool (``supports_paged`` False)."""
    if cfg.mla:
        raise ValueError(
            f"{cfg.arch_id}: paged KV cache covers the GQA layouts; the MLA "
            "latent cache keeps the contiguous path (supports_paged=False)")
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, hd)
    kvq = attn.kv_quant_format(cfg)
    if kvq:
        sdt = attn.KV_STORE_DTYPES[kvq]
        return {"k_pages": torch.zeros(shape, dtype=sdt, device=device),
                "k_scales": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_pages": torch.zeros(shape, dtype=sdt, device=device),
                "v_scales": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def contiguous_to_paged(cache: dict, block_size: int):
    """Reshape a contiguous (L, b, T, KV, hd) cache into a block pool plus
    identity block tables: row i owns blocks [i*MB, (i+1)*MB). T must be a
    multiple of ``block_size``. A quantized cache ({k_q, k_s, v_q, v_s},
    kvt layout (L, b, KV, T, ...)) maps to the quantized pool layout
    ({k_pages, k_scales, v_pages, v_scales}, time-major blocks)."""
    quant = "k_q" in cache
    first = cache["k_q"] if quant else cache["k"]
    L, b = first.shape[:2]
    t = first.shape[3] if quant else first.shape[2]
    if t % block_size:
        raise ValueError(f"cache_len {t} not a multiple of block_size {block_size}")
    mb = t // block_size

    def pool(leaf):
        if quant:                                 # (L, b, KV, T, ...) -> (L, b, T, KV, ...)
            leaf = leaf.movedim(3, 2)
        out = leaf.reshape(L, b * mb, block_size, *leaf.shape[3:])
        # a quantized pool is a layout of its own, and contiguous as the paged
        # kernel needs it (at b = 1 the reshape alone is a strided view)
        return out.contiguous() if quant else out

    table = torch.arange(b * mb, dtype=torch.int32, device=first.device).reshape(b, mb)
    if quant:
        return {"k_pages": pool(cache["k_q"]), "k_scales": pool(cache["k_s"]),
                "v_pages": pool(cache["v_q"]), "v_scales": pool(cache["v_s"])}, table
    return {"k_pages": pool(cache["k"]), "v_pages": pool(cache["v"])}, table


def _cache_names(cfg: ModelConfig) -> tuple[str, ...]:
    """The contiguous cache's leaves in the order a layer's attention
    returns its rows."""
    if cfg.mla:
        return ("ckv", "krope")
    return ("k_q", "k_s", "v_q", "v_s") if attn.kv_quant_format(cfg) else ("k", "v")


def lm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int,
               frontend_embeds: torch.Tensor | None = None,
               lengths: torch.Tensor | None = None, cache: dict | None = None):
    """Prompt pass: returns (last-position logits, populated cache).

    ``lengths`` (b,) enables ragged right-padded prompts: pad keys are
    masked (their cached K/V rows zeroed) and row i's logits are taken at
    position lengths[i]-1. ``cache``, an ``lm_init_cache`` tree of these
    shapes, is written in place (every slot of it) instead of a new one: a
    captured prefill's static cache (serving/graphs.py). ``frontend_embeds``
    (b, P, d) replace the first P positions' embeddings (pixtral)."""
    _check_ported(cfg)
    x = _embed(params, tokens, cfg, frontend_embeds)
    b = x.shape[0]
    if cache is None:
        cache = lm_init_cache(cfg, b, cache_len, x.dtype, x.device)
    names = _cache_names(cfg)
    for i, wkw in enumerate(_window_kw(cfg)):
        lp = tree_index(params["layers"], i)

        def attn_fn(h, lp=lp, i=i, wkw=wkw):
            if cfg.mla:
                y, leaves = attn.mla_prefill(lp["attn"], h, cfg, cache_len, lengths=lengths)
            else:
                y, leaves = attn.gqa_prefill(lp["attn"], h, cfg, cache_len, lengths=lengths,
                                             **wkw)
            for name, leaf in zip(names, leaves):
                cache[name][i] = leaf
            return y

        x = _block(lp, x, cfg, attn_fn)
    if lengths is None:
        last = x[:, -1, :]
    else:
        last = x[torch.arange(b, device=x.device), lengths - 1]
    return _logits(params, last, cfg), cache


def lm_decode(params, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig):
    """One decode step. token (b,); pos an int or (b,) per-request positions.
    Returns (logits (b, vocab_padded), cache); the cache is updated in place.

    By default the float cache is written by each layer before it attends
    (``gqa_decode``). Under ``flags.deferred_decode_cache``, the kvt layout
    (which implies it) or a quantized KV cache, the layers read the cache
    only and return their new rows, committed once after the last layer with
    one write per leaf (``commit_layers_bt``, or ``commit_layers_bkt`` for
    the (L, b, KV, T, ...) layouts), as in the reference; no layer reads its
    own uncommitted row from the cache.

    An MLA config's latent cache is never quantized nor kvt; any of those
    three flags (or ``deferred_decode_cache`` alone) selects the deferred
    ``mla_decode_deferred`` and one ``commit_layers_bt`` a leaf, as in the
    reference; else ``mla_decode`` writes each layer's rows before it
    attends."""
    _check_ported(cfg)
    if cfg.mla:
        quant = kvt = False
        deferred = any(bool(flags.get(f)) for f in (
            "deferred_decode_cache", "kvt_cache_layout", "int8_kv_cache"))
    else:
        quant = attn.kv_quant_format(cfg) is not None
        kvt = bool(flags.get("kvt_cache_layout")) or quant
        deferred = bool(flags.get("deferred_decode_cache")) or kvt
    x = _embed(params, token, cfg)
    rows: list = []
    for i, wkw in enumerate(_window_kw(cfg)):
        lp = tree_index(params["layers"], i)

        def attn_fn(h, lp=lp, i=i, wkw=wkw):
            if cfg.mla:
                c = (cache["ckv"][i], cache["krope"][i])
                if deferred:
                    y, r = attn.mla_decode_deferred(lp["attn"], h, c, pos, cfg)
                    rows.append(r)
                    return y
                return attn.mla_decode(lp["attn"], h, c, pos, cfg)[0]
            if quant:
                c = (cache["k_q"][i], cache["k_s"][i], cache["v_q"][i], cache["v_s"][i])
                y, r = attn.gqa_decode_deferred_quant(lp["attn"], h, c, pos, cfg, **wkw)
                rows.append(r)
                return y
            c = (cache["k"][i], cache["v"][i])
            if deferred:
                y, r = attn.gqa_decode_deferred(lp["attn"], h, c, pos, cfg, **wkw)
                rows.append(r)
                return y
            y, _ = attn.gqa_decode(lp["attn"], h, c, pos, cfg, **wkw)
            return y

        x = _block(lp, x, cfg, attn_fn)
    if deferred:
        commit = attn.commit_layers_bkt if kvt else attn.commit_layers_bt
        for j, name in enumerate(_cache_names(cfg)):
            commit(cache[name], torch.stack([r[j] for r in rows]), pos)
    return _logits(params, x, cfg), cache


def lm_decode_paged(params, token: torch.Tensor, cache: dict, block_table: torch.Tensor,
                    pos, cfg: ModelConfig):
    """One paged decode step. token (b,); cache the ``*_pages`` block pool;
    block_table (b, MB) physical block per virtual block; pos (b,) virtual
    positions (an int is broadcast). Returns (logits, cache).

    Deferred: the layers read the pool through the block table (the CUDA
    kernel on the card) and return only their new K/V rows, committed after
    the last layer with one scatter per leaf at each row's (physical block,
    offset) (``attention.commit_layers_paged``), in place. The pool keeps
    the base float layout: the kvt / int8_kv_cache flags raise."""
    if flags.get("kvt_cache_layout") or flags.get("int8_kv_cache"):
        raise ValueError("paged KV cache supports the base float KV layout "
                         "(kvt_cache_layout / int8_kv_cache flags off)")
    _check_ported(cfg)
    quant = attn.kv_quant_format(cfg) is not None
    if not isinstance(pos, torch.Tensor) or not pos.ndim:
        pos = torch.full((token.shape[0],), int(pos), dtype=torch.long, device=token.device)
    x = _embed(params, token, cfg)
    rows: list = []
    for i, wkw in enumerate(_window_kw(cfg)):
        lp = tree_index(params["layers"], i)

        def attn_fn(h, lp=lp, i=i, wkw=wkw):
            scales = (cache["k_scales"][i], cache["v_scales"][i]) if quant else None
            y, r = attn.gqa_decode_paged(
                lp["attn"], h, (cache["k_pages"][i], cache["v_pages"][i]), block_table,
                pos, cfg, scales=scales, **wkw)
            rows.append(r)
            return y

        x = _block(lp, x, cfg, attn_fn)
    names = ("k_pages", "k_scales", "v_pages", "v_scales") if quant else ("k_pages", "v_pages")
    for j, name in enumerate(names):
        attn.commit_layers_paged(cache[name], torch.stack([r[j] for r in rows]),
                                 block_table, pos)
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# speculative verify: k-token chunked decode
# ---------------------------------------------------------------------------

def _check_verify_layout(cfg: ModelConfig) -> None:
    if cfg.mla:
        raise ValueError(f"{cfg.arch_id}: speculative verify covers the GQA layouts; the "
                         "MLA latent cache keeps the single-token path (supports_spec=False)")
    if flags.get("kvt_cache_layout") or attn.kv_quant_format(cfg):
        raise ValueError("speculative verify supports the base float KV layout "
                         "(kvt_cache_layout / int8_kv_cache flags and kv_quant off)")


def _chunk_pos(pos, tokens: torch.Tensor) -> torch.Tensor:
    if not isinstance(pos, torch.Tensor) or not pos.ndim:
        return torch.full((tokens.shape[0],), int(pos), dtype=torch.long, device=tokens.device)
    return pos


def _verify(params, tokens: torch.Tensor, cfg: ModelConfig, cache: dict, names, pos, t: int,
            attn_fn, block_table=None):
    """The layer loop of a verify chunk, k decode steps' arithmetic row by
    row: the chunk's b·k rows run every projection as one GQMM (a row's
    int8, int4 or int3 result does not depend on how many rows the GQMM
    takes; fp8's small and large designs sum a group in other orders), the
    norms sum each chunk column apart (``rmsnorm_steps``),
    and ``attn_fn(i, lp, h, positions, steps, use_window)`` -> (y, (k, v))
    attends each column as its decode step. The attention writes the chunk's rows into
    the cache leaves ``names``; their old bits are restored after the last
    layer, so the cache leaves as it came. Returns (logits (b, k,
    vocab_padded), rows {k, v} (L, b, k, KV, hd))."""
    _check_ported(cfg)
    bs = cache[names[0]].shape[2] if block_table is not None else None
    positions, target, steps = attn.verify_steps(pos, tokens.shape[1], t, block_table, bs,
                                                 window=cfg.sliding_window)
    index = (slice(None),) + target
    saved = [cache[name][index] for name in names]
    x = _embed(params, tokens, cfg)
    ks, vs = [], []
    for i, use_window in enumerate(_layer_windows(cfg)):
        lp = tree_index(params["layers"], i)

        def layer_attn(h, lp=lp, i=i, use_window=use_window):
            y, (k, v) = attn_fn(i, lp, h, positions, steps, use_window)
            ks.append(k)
            vs.append(v)
            return y

        x = _block(lp, x, cfg, layer_attn, norm=rmsnorm_steps)
    for name, old in zip(names, saved):
        cache[name][index] = old
    logits = _logits(params, x, cfg, norm=rmsnorm_steps)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def lm_verify(params, tokens: torch.Tensor, cache: dict, pos, cfg: ModelConfig):
    """Chunked multi-token decode for speculative verification. tokens
    (b, k): the current token followed by k-1 drafted candidates; cache the
    contiguous {k, v} layout; pos (b,) or an int, the virtual position of
    tokens[:, 0]. Returns (logits (b, k, vocab_padded), rows {k, v} (L, b,
    k, KV, hd)). Row j's logits are those of the decode step that would
    follow committing rows 0..j-1, bit for bit (``attention.gqa_verify``).
    The cache comes back unchanged; the caller commits only the accepted
    prefix (``lm_commit_verify``)."""
    _check_verify_layout(cfg)
    pos = _chunk_pos(pos, tokens)
    return _verify(params, tokens, cfg, cache, ("k", "v"), pos, cache["k"].shape[2],
                   lambda i, lp, h, positions, steps, uw: attn.gqa_verify(
                       lp["attn"], h, (cache["k"][i], cache["v"][i]), positions, steps, cfg,
                       use_window=uw))


def lm_commit_verify(cache: dict, rows: dict, pos: torch.Tensor, n_commit: torch.Tensor
                     ) -> dict:
    """Commit the accepted prefix of a verify chunk in place: rows[:, i, :n]
    land at positions pos[i]..pos[i]+n-1 for n = n_commit[i]; rejected rows
    change nothing, so the cache is bit-identical to a trajectory that never
    drafted them (rollback is ``pos + n_commit``)."""
    for name in ("k", "v"):
        attn.commit_layers_verify(cache[name], rows[name], pos, n_commit)
    return cache


def lm_verify_paged(params, tokens: torch.Tensor, cache: dict, block_table: torch.Tensor,
                    pos, cfg: ModelConfig):
    """Paged sibling of :func:`lm_verify`: each chunk column runs the paged
    decode step's attention (``ops.paged_attention``, the CUDA kernel on the
    card) through each row's block table over the ``*_pages`` pool. Same
    return contract; commit with :func:`lm_commit_verify_paged`."""
    _check_verify_layout(cfg)
    pos = _chunk_pos(pos, tokens)
    t = block_table.shape[1] * cache["k_pages"].shape[2]
    return _verify(params, tokens, cfg, cache, ("k_pages", "v_pages"), pos, t,
                   lambda i, lp, h, positions, steps, uw: attn.gqa_verify_paged(
                       lp["attn"], h, (cache["k_pages"][i], cache["v_pages"][i]), block_table,
                       positions, steps, cfg, use_window=uw),
                   block_table=block_table)


def lm_commit_verify_paged(cache: dict, rows: dict, block_table: torch.Tensor,
                           pos: torch.Tensor, n_commit: torch.Tensor) -> dict:
    """Commit the accepted prefix into the block pool in place (rejected rows
    change nothing, block 0 included)."""
    for name in ("k", "v"):
        attn.commit_layers_paged_verify(cache[f"{name}_pages"], rows[name], block_table, pos,
                                        n_commit)
    return cache
