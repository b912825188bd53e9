"""Uniform model API (counterpart of ``repro/models/registry.py``).

Ported: the ``decoder_lm`` family (the dense GQA archs TinyLlama-1.1B,
internlm2-1.8b, deepseek-coder-33b, pixtral-12b (its ViT frontend a stub:
the caller's ``batch["patch_embeds"]`` replace the first positions, as in
the reference) and gemma2-2b; dbrx-132b (GQA with a 16-expert MoE FFN);
and the MLA archs minicpm3-4b (dense FFN) and deepseek-v2-lite-16b (MoE
with shared experts)), and the recurrent families rwkv6-7b
(``models/rwkv.py``) and zamba2-7b (Mamba2 with a shared attention block,
``models/zamba.py``), and the encoder-decoder seamless-m4t-large-v2
(``models/encdec.py``; its speech frontend a stub: the caller's
``batch["frames"]``): all 11 configs. ``Model``
keeps the reference's entry points (the scoring ``forward``, ``prefill``,
``decode``) and its capability flags, each declared explicitly and equal
to the reference's for every ported arch: for ``decoder_lm`` ragged
lengths and the serving core's slot hooks (``cache_kind="kv"``,
``insert_slots``/``gather_slots``); the paged block-pool cache
(``init_paged_cache``/``decode_paged``) and speculative verify over both
caches (``verify``/``commit_verify`` and their paged siblings) for the GQA
archs only (the MLA latent cache keeps the contiguous single-token path,
its hooks None, as in the reference). The recurrent families declare
``cache_kind="state"`` with both slot hooks (``RecurrentAdapter``) and no
ragged lengths, paged cache or verify: a recurrent prefill cannot skip pad
tokens, so the serving front ends group them by exact length. The
encoder-decoder declares none of them (``cache_kind="none"``, no hooks), as
in the reference: its cross K/V is per-request state no slot or paged
scheduler carries, so it serves through ``generate`` (bucketed).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.tree import tree_map
from repro_torch.models import encdec as _encdec
from repro_torch.models import rwkv as _rwkv
from repro_torch.models import transformer as _tf
from repro_torch.models import zamba as _zamba

ARCH_IDS = [
    "tinyllama-1.1b",
    "pixtral-12b",
    "rwkv6-7b",
    "minicpm3-4b",
    "deepseek-coder-33b",
    "gemma2-2b",
    "internlm2-1.8b",
    "dbrx-132b",
    "deepseek-v2-lite-16b",
    "zamba2-7b",
    "seamless-m4t-large-v2",
]

PORTED_ARCHS = ("tinyllama-1.1b", "internlm2-1.8b", "deepseek-coder-33b", "pixtral-12b",
                "gemma2-2b", "dbrx-132b", "minicpm3-4b", "deepseek-v2-lite-16b",
                "rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2")


def load_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable               # (seed=0, device="cuda") -> params
    forward: Callable            # (params, batch, remat=True) -> logits (b, s, vocab_padded)
    init_cache: Callable         # (batch, cache_len, dtype, device) -> cache; the
    #                              encdec's also takes memory_len (its cross K/V rows)
    prefill: Callable            # (params, batch, cache_len, cache=None) -> (logits, cache)
    decode: Callable             # (params, token, cache, pos) -> (logits, cache)
    # the reference's capability surface (see repro.models.registry.Model)
    supports_lengths: bool = False
    supports_paged: bool = False
    init_paged_cache: Callable | None = None   # (num_blocks, block_size, dtype, device) -> pool
    decode_paged: Callable | None = None       # (params, tok, pool, table, pos) -> (logits, pool)
    # speculative verify: a k-token chunk's logits, the cache left as found,
    # and a commit of the accepted prefix only (in place)
    supports_spec: bool = False
    verify: Callable | None = None             # (params, toks (b,k), cache, pos) -> (logits (b,k,V), rows)
    commit_verify: Callable | None = None      # (cache, rows, pos, n_commit) -> cache
    verify_paged: Callable | None = None       # (params, toks, pool, table, pos) -> (logits, rows)
    commit_verify_paged: Callable | None = None  # (pool, rows, table, pos, n_commit) -> pool
    cache_kind: str = "none"
    insert_slots: Callable | None = None       # (cache, rows, slots) -> cache
    gather_slots: Callable | None = None       # (cache, slots) -> per-slot rows


def _recurrent(cfg: ModelConfig, init, forward, init_cache, prefill, decode, insert,
               gather) -> Model:
    """A recurrent family's Model: recurrent state cannot skip pad tokens,
    has no paged layout and no uncommitted k-token verify (the reference's
    exclusions); the slot hooks make continuous batching a state scatter
    (``serving/core.RecurrentAdapter``)."""
    return Model(
        cfg=cfg,
        init=lambda seed=0, device="cuda": init(cfg, device, seed=seed),
        forward=forward,
        init_cache=init_cache,
        prefill=lambda params, batch, cache_len, cache=None: prefill(
            params, batch["tokens"], cfg, cache_len, cache=cache),
        decode=lambda p, tok, cache, pos: decode(p, tok, cache, pos, cfg),
        supports_lengths=False,
        supports_paged=False,
        supports_spec=False,
        cache_kind="state",
        insert_slots=insert,
        gather_slots=gather,
    )


def build(cfg: ModelConfig) -> Model:
    if cfg.model_type == "rwkv6":
        return _recurrent(
            cfg, _rwkv.init_rwkv,
            lambda params, batch, remat=True: _rwkv.rwkv_forward(
                params, batch["tokens"], cfg, remat=remat),
            lambda b, t, dt, device: _rwkv.rwkv_init_state(cfg, b, dt, device),
            _rwkv.rwkv_prefill, _rwkv.rwkv_decode, _rwkv.rwkv_insert_slots,
            _rwkv.rwkv_gather_slots)
    if cfg.model_type == "zamba2":
        return _recurrent(
            cfg, _zamba.init_zamba,
            lambda params, batch, remat=True: _zamba.zamba_forward(
                params, batch["tokens"], cfg, remat=remat),
            lambda b, t, dt, device: _zamba.zamba_init_cache(cfg, b, t, dt, device),
            _zamba.zamba_prefill, _zamba.zamba_decode, _zamba.zamba_insert_slots,
            _zamba.zamba_gather_slots)
    if cfg.model_type == "encdec":
        # the encoder output is per-request state the slot and paged
        # schedulers don't carry; the decoder cache stays contiguous and
        # bucket-served (the reference's flags)
        return Model(
            cfg=cfg,
            init=lambda seed=0, device="cuda": _encdec.init_encdec(cfg, device, seed=seed),
            forward=lambda params, batch, remat=True: _encdec.encdec_forward(
                params, batch, cfg, remat=remat),
            init_cache=lambda b, t, dt, device, memory_len=_encdec.DEFAULT_MEMORY_LEN: (
                _encdec.encdec_init_cache(cfg, b, t, dt, device, memory_len)),
            prefill=lambda params, batch, cache_len, cache=None: _encdec.encdec_prefill(
                params, batch, cfg, cache_len, cache=cache),
            decode=lambda p, tok, cache, pos: _encdec.encdec_decode(p, tok, cache, pos, cfg),
            supports_lengths=False,
            supports_paged=False,
            supports_spec=False,
            cache_kind="none",
        )
    if cfg.model_type != "decoder_lm":
        raise ValueError(f"unknown model_type: {cfg.model_type}")
    _tf._check_ported(cfg)

    def forward(params, batch, remat=True):
        return _tf.lm_forward(params, batch["tokens"], cfg,
                              frontend_embeds=batch.get("patch_embeds"), remat=remat)

    def prefill(params, batch, cache_len, cache=None):
        return _tf.lm_prefill(params, batch["tokens"], cfg, cache_len,
                              frontend_embeds=batch.get("patch_embeds"),
                              lengths=batch.get("lengths"), cache=cache)

    # the paged pool and speculative verify cover the GQA layouts; the MLA
    # latent cache keeps the contiguous single-token path (the reference's rule)
    paged = not cfg.mla
    return Model(
        cfg=cfg,
        init=lambda seed=0, device="cuda": _tf.init_lm(cfg, device, seed=seed),
        forward=forward,
        init_cache=lambda b, t, dt, device: _tf.lm_init_cache(cfg, b, t, dt, device),
        prefill=prefill,
        decode=lambda p, tok, cache, pos: _tf.lm_decode(p, tok, cache, pos, cfg),
        supports_lengths=True,
        supports_paged=paged,
        init_paged_cache=(lambda nb, bs, dt, device: _tf.lm_init_paged_cache(
            cfg, nb, bs, dt, device)) if paged else None,
        decode_paged=(lambda p, tok, cache, table, pos: _tf.lm_decode_paged(
            p, tok, cache, table, pos, cfg)) if paged else None,
        supports_spec=paged,
        verify=(lambda p, toks, cache, pos: _tf.lm_verify(p, toks, cache, pos, cfg))
        if paged else None,
        commit_verify=_tf.lm_commit_verify if paged else None,
        verify_paged=(lambda p, toks, cache, table, pos: _tf.lm_verify_paged(
            p, toks, cache, table, pos, cfg)) if paged else None,
        commit_verify_paged=_tf.lm_commit_verify_paged if paged else None,
        cache_kind="kv",
        insert_slots=_tf.lm_insert_slots,
        gather_slots=_tf.lm_gather_slots,
    )


# ---------------------------------------------------------------------------
# shapes without allocation (meta tensors, torch's jax.eval_shape) + smoke
# batches
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_struct(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as meta tensors: the paths, shapes and
    dtypes ``Model.init`` gives, with nothing allocated (``init`` runs on
    fake tensors; full-size dbrx is 132 B parameters)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = build(cfg).init(seed=0, device="cpu")
    return tree_map(lambda t: _meta(t.shape, t.dtype), fake)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for the step inputs of one (arch, shape) cell, the
    reference's ``ShapeDtypeStruct``s: ``decode`` kinds describe only
    (token, pos); the cache comes from ``cache_specs``."""
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), tok), "labels": _meta((b, s), tok)}
        if cfg.model_type == "encdec":
            batch["frames"] = _meta((b, s, cfg.d_model), cfg.cdtype())
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = _meta((b, cfg.num_frontend_tokens, cfg.d_model), cfg.cdtype())
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), tok)}
        if cfg.model_type == "encdec":
            # the encoder takes the whole source; the decoder is primed with
            # a short prompt (64): the 32k prefill's cost is the encoder's
            batch = {"frames": _meta((b, s, cfg.d_model), cfg.cdtype()),
                     "tokens": _meta((b, 64), tok)}
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = _meta((b, cfg.num_frontend_tokens, cfg.d_model), cfg.cdtype())
        return batch
    # decode: one new token against a cache of seq_len
    return {"token": _meta((b,), tok), "pos": _meta((), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The cache tree of a decode cell as meta tensors (nothing allocated)."""
    return build(cfg).init_cache(shape.global_batch, shape.seq_len, cfg.cdtype(), "meta")


def smoke_batch(cfg: ModelConfig, *, batch: int = 2, seq: int = 16, seed: int = 0) -> dict:
    """Small concrete batch as numpy arrays, the reference's draws from
    ``numpy.random.default_rng(seed)``: tokens, labels (tokens shifted by
    one) and, for pixtral's patch-embed stub, ``patch_embeds`` (batch,
    num_frontend_tokens, d_model) f32, and for the encoder-decoder ``frames``
    (batch, seq, d_model) f32, drawn after the tokens. Hand it to
    ``forward``/``prefill`` through ``torch.as_tensor``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.model_type == "encdec":
        out["frames"] = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch_embed":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out
