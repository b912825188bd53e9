"""Zamba2 hybrid (counterpart of ``repro/models/zamba.py``): a Mamba2
backbone and one SHARED attention block (GQA + SwiGLU) applied after every
``shared_attn_every`` Mamba2 layers.

The shared block has one parameter set, reused at every application, and
one KV cache per application. The Mamba2 layers are stacked (groups, per,
...) with a tail of the remaining layers (tail, ...): num_layers = groups ·
per + tail (zamba2-7b: 81 = 13 · 6 + 3; at 2 layers the full config has no
group, so no shared block runs). As in the reference, the shared block's
input is the running stream only (the released model's embedding
concatenation and per-application LoRA deltas are not modelled).

The shared KV cache takes the kvt layout (groups, b, KV, T, hd) under
``flags.kvt_cache_layout`` or ``flags.int8_kv_cache``, and always stores
floats; decode is deferred under either flag (the rows of every
application committed after the groups, ``commit_layers_bkt`` /
``commit_layers_bt``). Under ``int8_kv_cache`` alone the reference's
prefill returns the base layout its own decode cannot read (ROADMAP Queue
C); the port's prefill writes the kvt layout its cache and decode use.
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
from repro_torch.models.common import dense_init, embed_init, remat_call, rmsnorm
from repro_torch.models.ssm import init_mamba2, mamba2_decode, mamba2_forward, ssm_dims


def _layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(groups, per_group, tail): num_layers = groups * per_group + tail."""
    k = cfg.shared_attn_every
    return cfg.num_layers // k, k, cfg.num_layers % k


def _shared_kvt() -> bool:
    return bool(flags.get("kvt_cache_layout") or flags.get("int8_kv_cache"))


def init_zamba(cfg: ModelConfig, device="cuda", *, seed: int = 0) -> dict:
    """Random parameters in the reference's tree from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (``bridge.init_params_numpy`` gives
    both packages the same ones): ``mamba_layers`` (groups, per, ...),
    ``shared`` {att_norm, attn, ffn_norm, mlp} and, where num_layers is no
    multiple of shared_attn_every, ``tail_layers`` (tail, ...)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    groups, per, tail = _layout(cfg)
    dt, d = cfg.pdtype(), cfg.d_model

    def mamba_layers(lead):
        return {"norm": torch.ones((*lead, d), dtype=dt, device=dev),
                "mamba": init_mamba2(gen, cfg, lead)}

    params = {
        "embed": embed_init(gen, cfg.vocab_padded, d, dt),
        "mamba_layers": mamba_layers((groups, per)),
        "shared": {"att_norm": torch.ones((d,), dtype=dt, device=dev),
                   "attn": attn.init_gqa(gen, cfg),
                   "ffn_norm": torch.ones((d,), dtype=dt, device=dev),
                   "mlp": mlpmod.init_mlp(gen, cfg)},
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "classifier": dense_init(gen, cfg.vocab_padded, d, dt),
    }
    if tail:
        params["tail_layers"] = mamba_layers((tail,))
    return params


def _mamba_layers(params) -> list[tuple[tuple, dict]]:
    """((group, j) or (j,), the layer's views) of every Mamba2 layer in
    order, the groups' first; a group's last layer is followed by the
    shared block."""
    groups, per = params["mamba_layers"]["norm"].shape[:2]
    out = [((g, j), tree_index(tree_index(params["mamba_layers"], g), j))
           for g in range(groups) for j in range(per)]
    if "tail_layers" in params:
        out += [((j,), tree_index(params["tail_layers"], j))
                for j in range(params["tail_layers"]["norm"].shape[0])]
    return out


def _shared_block(sp, x: torch.Tensor, cfg: ModelConfig, attn_fn) -> torch.Tensor:
    x = x + attn_fn(rmsnorm(x, sp["att_norm"], cfg.norm_eps))
    return x + mlpmod.mlp_forward(sp["mlp"], rmsnorm(x, sp["ffn_norm"], cfg.norm_eps))


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return embedding_lookup(params["embed"], tokens, cfg.cdtype())


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return linear(params["classifier"], rmsnorm(x, params["final_norm"], cfg.norm_eps))


def zamba_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, remat: bool = True
                  ) -> torch.Tensor:
    """tokens (b, s) -> logits (b, s, vocab_padded). With ``remat`` and grad
    enabled each Mamba2 layer is recomputed in the backward
    (``common.remat_call``) and the shared block is not, as in the
    reference (``jax.checkpoint`` of the Mamba2 body only); the shared
    block's gradient sums over its applications."""
    x = _embed(params, tokens, cfg)
    sp, per = params["shared"], cfg.shared_attn_every
    for where, lp in _mamba_layers(params):
        x = remat_call(lambda x, lp=lp: x + mamba2_forward(
            lp["mamba"], rmsnorm(x, lp["norm"], cfg.norm_eps), cfg)[0], x, remat)
        if len(where) == 2 and where[1] == per - 1:
            x = _shared_block(sp, x, cfg, lambda h: attn.gqa_forward(sp["attn"], h, cfg))
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def zamba_init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    """{mamba: {conv (groups, per, b, k-1, c), h (groups, per, b, H, hd, N)
    f32}, shared_k / shared_v (groups, b, T, KV, hd), or (groups, b, KV, T,
    hd) under the kvt or int8 KV flags, in ``dtype``, and with a tail its
    {conv, h} (tail, b, ...)}."""
    groups, per, tail = _layout(cfg)
    _, nheads, conv_ch = ssm_dims(cfg)
    s, hd = cfg.ssm, cfg.resolved_head_dim

    def mamba_state(*lead):
        return {"conv": torch.zeros((*lead, batch, s.conv_kernel - 1, conv_ch), dtype=dtype,
                                    device=device),
                "h": torch.zeros((*lead, batch, nheads, s.head_dim, s.state_dim),
                                 dtype=torch.float32, device=device)}

    if _shared_kvt():
        kv_shape = (groups, batch, cfg.num_kv_heads, cache_len, hd)
    else:
        kv_shape = (groups, batch, cache_len, cfg.num_kv_heads, hd)
    cache = {"mamba": mamba_state(groups, per),
             "shared_k": torch.zeros(kv_shape, dtype=dtype, device=device),
             "shared_v": torch.zeros(kv_shape, dtype=dtype, device=device)}
    if tail:
        cache["tail"] = mamba_state(tail)
    return cache


def _slot_index(name: str, slots) -> tuple:
    """The batch axis of a cache leaf by its top-level key: 2 for the
    (groups, per, b, ...) Mamba2 states, 1 for shared_k / shared_v
    ((groups, b, ...) in both layouts) and the tail's (tail, b, ...)."""
    return (slice(None),) * (2 if name == "mamba" else 1) + (slots,)


def _leaves(cache: dict):
    for name, node in cache.items():
        for leaf_name, leaf in (node.items() if isinstance(node, dict) else [(None, node)]):
            yield name, leaf_name, leaf


def zamba_insert_slots(cache: dict, rows: dict, slots: torch.Tensor) -> dict:
    """Scatter per-request prefill ``rows`` (SSM states and shared KV) into
    decode ``slots`` of a batched cache, in place (the serving core's
    ``RecurrentAdapter``); the batch axis depends on the leaf."""
    for name, leaf_name, big in _leaves(cache):
        small = rows[name] if leaf_name is None else rows[name][leaf_name]
        big[_slot_index(name, slots)] = small
    return cache


def zamba_gather_slots(cache: dict, slots: torch.Tensor) -> dict:
    """Inverse of ``zamba_insert_slots``: per-slot state rows for ``slots``."""
    out: dict = {}
    for name, leaf_name, big in _leaves(cache):
        taken = big[_slot_index(name, slots)]
        if leaf_name is None:
            out[name] = taken
        else:
            out.setdefault(name, {})[leaf_name] = taken
    return out


def _state_views(cache: dict, where: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    st = cache["mamba"] if len(where) == 2 else cache["tail"]
    return st["conv"][where], st["h"][where]


def zamba_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int,
                  cache: dict | None = None):
    """Run the prompt: (last-position logits, cache). ``cache``, a
    ``zamba_init_cache`` tree of this batch and ``cache_len``, is written
    in place instead of a new one (a captured prefill's static cache)."""
    x = _embed(params, tokens, cfg)
    if cache is None:
        cache = zamba_init_cache(cfg, x.shape[0], cache_len, x.dtype, x.device)
    sp, per, kvt = params["shared"], cfg.shared_attn_every, _shared_kvt()
    for where, lp in _mamba_layers(params):
        y, (conv, h) = mamba2_forward(lp["mamba"], rmsnorm(x, lp["norm"], cfg.norm_eps), cfg)
        x = x + y
        conv_c, h_c = _state_views(cache, where)
        conv_c.copy_(conv)
        h_c.copy_(h)
        if len(where) == 2 and where[1] == per - 1:
            g = where[0]

            def attn_fn(hn, g=g):
                # the shared cache stores floats, kvt under either KV flag
                with flags.overrides(int8_kv_cache=False, kvt_cache_layout=kvt):
                    out, (k, v) = attn.gqa_prefill(sp["attn"], hn, cfg, cache_len)
                cache["shared_k"][g], cache["shared_v"][g] = k, v
                return out

            x = _shared_block(sp, x, cfg, attn_fn)
    return _logits(params, x[:, -1, :], cfg), cache


def zamba_decode(params, token: torch.Tensor, cache: dict, pos, cfg: ModelConfig):
    """One decode step: token (b,), pos an int or (b,) positions. The Mamba2
    states update in place; the shared cache is written by each
    application before it attends, or, deferred (``deferred_decode_cache``,
    or the kvt / int8 KV flags), committed after the groups with one write
    a leaf. Returns (logits (b, vocab_padded), cache)."""
    x = _embed(params, token, cfg)
    sp, per = params["shared"], cfg.shared_attn_every
    kvt = _shared_kvt()
    deferred = bool(flags.get("deferred_decode_cache")) or kvt
    rows: list = []
    for where, lp in _mamba_layers(params):
        x = x + mamba2_decode(lp["mamba"], rmsnorm(x, lp["norm"], cfg.norm_eps),
                              _state_views(cache, where), cfg)[0]
        if len(where) == 2 and where[1] == per - 1:
            g = where[0]

            def attn_fn(hn, g=g):
                c = (cache["shared_k"][g], cache["shared_v"][g])
                with flags.overrides(int8_kv_cache=False, kvt_cache_layout=kvt):
                    if deferred:
                        out, r = attn.gqa_decode_deferred(sp["attn"], hn, c, pos, cfg)
                        rows.append(r)
                        return out
                    return attn.gqa_decode(sp["attn"], hn, c, pos, cfg)[0]

            x = _shared_block(sp, x, cfg, attn_fn)
    if deferred and rows:
        commit = attn.commit_layers_bkt if kvt else attn.commit_layers_bt
        for j, name in enumerate(("shared_k", "shared_v")):
            commit(cache[name], torch.stack([r[j] for r in rows]), pos)
    return _logits(params, x, cfg), cache
