"""RWKV6 "Finch" (counterpart of ``repro/models/rwkv.py``): attention-free
LM with data-dependent per-channel decay.

Each layer is a time mix (the WKV6 recurrence) and a channel mix (a gated
FFN), both with token shift. The mixing matrices (``wr``, ``wk``, ``wv``,
``wg``, ``wout``, ``wffr``, ``wff1``, ``wff2``) and the classifier go
through ``linear`` (GQMM under quantized weights); the decay LoRA, the
token-shift mixes and ``bonus_u`` stay float (the policy's exclusions), so
``_decay``'s two products are float matmuls in x's dtype. The WKV scan has
no Pallas kernel behind it in the reference and is plain PyTorch: a loop
over positions on the f32 state (b, h, hd, hd), updated in place; autograd
differentiates it as it does an out-of-place loop (the same gradient, bit
for bit).

The decode state is {att_x, wkv, ffn_x}, each (L, b, ...), O(1) in the
sequence length; ``rwkv_decode`` updates it in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import embedding_lookup, linear
from repro_torch.core.tree import tree_index
from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init, embed_init, remat_call, rmsnorm
from repro_torch.models.mlp import _stacked_init

DECAY_LORA_RANK = 64
MIXES = ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w")


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.resolved_head_dim
    return cfg.d_model // hd, hd


def init_rwkv_layer(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The reference's layer leaves, ``lead`` stacked: norms ones, mixes 0.5,
    ``decay_w0`` -6, the decay LoRA, ``bonus_u`` N(0, 0.1²) and the mixing
    matrices N(0, 1/in)."""
    d, f = cfg.d_model, cfg.d_ff
    h, hd = _heads(cfg)
    dt, dev = cfg.pdtype(), gen.device

    def full(v):
        return torch.full((*lead, d), v, dtype=dt, device=dev)

    p = {"att_norm": full(1.0), **{m: full(0.5) for m in MIXES}, "decay_w0": full(-6.0),
         "decay_lora_a": dense_init(gen, DECAY_LORA_RANK, d, dt, lead),
         "decay_lora_b": dense_init(gen, d, DECAY_LORA_RANK, dt, lead),
         "bonus_u": (torch.randn((*lead, h, hd), generator=gen, device=dev,
                                 dtype=torch.float32) * 0.1).to(dt)}
    for name in ("wr", "wk", "wv", "wg", "wout"):
        p[name] = _stacked_init(gen, d, d, dt, lead)
    p.update({"ffn_norm": full(1.0), "mix_ffn": full(0.5),
              "wffr": _stacked_init(gen, d, d, dt, lead),
              "wff1": _stacked_init(gen, f, d, dt, lead),
              "wff2": _stacked_init(gen, d, f, dt, lead)})
    return p


def _token_shift(x: torch.Tensor, x_prev_first: torch.Tensor) -> torch.Tensor:
    """x (b, s, d) shifted right by one; position 0 sees ``x_prev_first``."""
    return torch.cat([x_prev_first[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(x: torch.Tensor, shifted: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    return x + (shifted - x) * mix


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1): w = exp(-exp(w0 + lora)),
    the LoRA's two float products in x's dtype, the exponentials in f32."""
    lora = linear(p["decay_lora_b"], torch.tanh(linear(p["decay_lora_a"], xw)))
    return torch.exp(-torch.exp((p["decay_w0"] + lora).to(torch.float32)))


def _wkv_scan(r, k, v, w, u, state: torch.Tensor) -> torch.Tensor:
    """WKV6 over positions, the reference's ``_wkv_step`` at each: r, k, v,
    w (b, s, h, hd) f32; u (h, hd) f32; ``state`` (b, h, hd [k], hd [v]) f32,
    updated IN PLACE. A step: a = k (x) v; y = r . (state + u a); state =
    w state + a. Returns y (b, s, h, hd)."""
    ub = u[:, :, None]
    ys = []
    for t in range(r.shape[1]):
        a = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.matmul(r[:, t, :, None, :], torch.addcmul(state, ub, a))[..., 0, :])
        state.mul_(w[:, t, :, :, None]).add_(a)
    return torch.stack(ys, dim=1)


def _mix_rkvgw(p, x: torch.Tensor, shifted: torch.Tensor):
    """The four projections and the decay from their token-shift mixes, in
    the reference's order."""
    r = linear(p["wr"], _ddlerp(x, shifted, p["mix_r"]))
    k = linear(p["wk"], _ddlerp(x, shifted, p["mix_k"]))
    v = linear(p["wv"], _ddlerp(x, shifted, p["mix_v"]))
    g = linear(p["wg"], _ddlerp(x, shifted, p["mix_g"]))
    w = _decay(p, _ddlerp(x, shifted, p["mix_w"]))
    return r, k, v, g, w


def _time_mix_out(p, y: torch.Tensor, g: torch.Tensor, x_dtype, cfg: ModelConfig, *,
                  cast_first: bool):
    """The per-head group norm (rmsnorm over hd with a ones weight in x's
    dtype), the gate and ``wout``. y (..., h, hd) f32. As in the reference,
    the sequence form rounds y to x's dtype before the norm
    (``cast_first``), the decode step normalizes the f32 y and rounds
    after."""
    h, hd = _heads(cfg)
    ones = torch.ones((hd,), dtype=x_dtype, device=y.device)
    if cast_first:
        y = rmsnorm(y.to(x_dtype), ones, cfg.norm_eps)
    else:
        y = rmsnorm(y, ones, cfg.norm_eps).to(x_dtype)
    y = y.reshape(*y.shape[:-2], h * hd)
    return linear(p["wout"], y * F.silu(g))


def time_mix_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None):
    """Full-sequence WKV6. x (b, s, d); ``state`` (x_first, wkv) continues a
    sequence (its wkv is not written). Returns (y, (x_last, wkv_last))."""
    b, s, d = x.shape
    h, hd = _heads(cfg)
    if state is None:
        x_first = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        wkv = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    else:
        x_first, wkv = state[0], state[1].clone()
    r, k, v, g, w = _mix_rkvgw(p, x, _token_shift(x, x_first))
    f32 = [t.reshape(b, s, h, hd).to(torch.float32) for t in (r, k, v, w)]
    y = _wkv_scan(*f32, p["bonus_u"].to(torch.float32), wkv)
    return _time_mix_out(p, y, g, x.dtype, cfg, cast_first=True), (x[:, -1, :], wkv)


def time_mix_decode(p, x: torch.Tensor, state, cfg: ModelConfig):
    """x (b, d) one token; state (x_prev (b, d), wkv (b, h, hd, hd)), views
    of the caller's state, both updated IN PLACE. Returns (y, state)."""
    b, d = x.shape
    h, hd = _heads(cfg)
    x_prev, wkv = state
    r, k, v, g, w = _mix_rkvgw(p, x, x_prev)
    f32 = [t.reshape(b, 1, h, hd).to(torch.float32) for t in (r, k, v)]
    y = _wkv_scan(*f32, w.reshape(b, 1, h, hd), p["bonus_u"].to(torch.float32), wkv)
    x_prev.copy_(x)
    return _time_mix_out(p, y[:, 0], g, x.dtype, cfg, cast_first=False), (x_prev, wkv)


def _channel_mix(p, x: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    xm = _ddlerp(x, shifted, p["mix_ffn"])
    kk = torch.square(torch.relu(linear(p["wff1"], xm)))
    return torch.sigmoid(linear(p["wffr"], xm)) * linear(p["wff2"], kk)


def channel_mix_forward(p, x: torch.Tensor, state=None):
    """x (b, s, d) -> (y, x_last); ``state`` the previous token's x."""
    x_first = torch.zeros_like(x[:, 0, :]) if state is None else state
    return _channel_mix(p, x, _token_shift(x, x_first)), x[:, -1, :]


def channel_mix_decode(p, x: torch.Tensor, x_prev: torch.Tensor):
    """x (b, d); ``x_prev`` (a view of the caller's state) becomes x in place."""
    out = _channel_mix(p, x, x_prev)
    x_prev.copy_(x)
    return out, x_prev


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_rwkv(cfg: ModelConfig, device="cuda", *, seed: int = 0) -> dict:
    """Random parameters in the reference's tree, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (other numbers
    than the reference's; ``bridge.init_params_numpy`` gives both packages
    the same ones). Layer leaves are stacked (L, ...); the large matrices
    are drawn a layer at a time."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt, d = cfg.pdtype(), cfg.d_model
    return {"embed": embed_init(gen, cfg.vocab_padded, d, dt),
            "layers": init_rwkv_layer(gen, cfg, (cfg.num_layers,)),
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
            "classifier": dense_init(gen, cfg.vocab_padded, d, dt)}


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return linear(params["classifier"], rmsnorm(x, params["final_norm"], cfg.norm_eps))


def _layer(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = x + time_mix_forward(lp, rmsnorm(x, lp["att_norm"], cfg.norm_eps), cfg)[0]
    return x + channel_mix_forward(lp, rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))[0]


def rwkv_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, remat: bool = True
                 ) -> torch.Tensor:
    """tokens (b, s) -> logits (b, s, vocab_padded). With ``remat`` and grad
    enabled each layer (time mix and channel mix) is recomputed in the
    backward (``common.remat_call``), as the reference's
    ``jax.checkpoint(body)`` does: a layer keeps only its input, not the
    scan's per-position states."""
    x = embedding_lookup(params["embed"], tokens, cfg.cdtype())
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        x = remat_call(lambda x, lp=lp: _layer(lp, x, cfg), x, remat)
    return _logits(params, x, cfg)


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    h, hd = _heads(cfg)
    L, d = cfg.num_layers, cfg.d_model
    return {"att_x": torch.zeros((L, batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((L, batch, h, hd, hd), dtype=torch.float32, device=device),
            "ffn_x": torch.zeros((L, batch, d), dtype=dtype, device=device)}


def rwkv_insert_slots(state: dict, rows: dict, slots: torch.Tensor) -> dict:
    """Scatter per-request prefill ``rows`` into decode ``slots`` of a
    batched recurrent state, in place: every leaf is (L, b, ...), so a slot
    is one axis-1 scatter (the serving core's ``RecurrentAdapter``)."""
    for name, big in state.items():
        big[:, slots] = rows[name]
    return state


def rwkv_gather_slots(state: dict, slots: torch.Tensor) -> dict:
    """Inverse of ``rwkv_insert_slots``: the per-slot state for ``slots``."""
    return {name: big[:, slots] for name, big in state.items()}


def rwkv_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache_len: int,
                 cache: dict | None = None):
    """Run the prompt: (last-position logits, decode state). ``cache_len``
    is unused (the state is O(1)) and kept for the interface; ``cache``, an
    ``rwkv_init_state`` tree of this batch, is written in place instead of
    a new one (a captured prefill's static state)."""
    del cache_len
    x = embedding_lookup(params["embed"], tokens, cfg.cdtype())
    if cache is None:
        cache = rwkv_init_state(cfg, x.shape[0], x.dtype, x.device)
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        att, (ax, wkv) = time_mix_forward(lp, rmsnorm(x, lp["att_norm"], cfg.norm_eps), cfg)
        x = x + att
        ffn, fx = channel_mix_forward(lp, rmsnorm(x, lp["ffn_norm"], cfg.norm_eps))
        x = x + ffn
        cache["att_x"][i], cache["wkv"][i], cache["ffn_x"][i] = ax, wkv, fx
    return _logits(params, x[:, -1, :], cfg), cache


def rwkv_decode(params, token: torch.Tensor, state: dict, pos, cfg: ModelConfig):
    """token (b,) -> (logits (b, vocab_padded), state), the state updated in
    place. ``pos`` is unused: the state carries every position."""
    del pos
    x = embedding_lookup(params["embed"], token, cfg.cdtype())
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        att, _ = time_mix_decode(lp, rmsnorm(x, lp["att_norm"], cfg.norm_eps),
                                 (state["att_x"][i], state["wkv"][i]), cfg)
        x = x + att
        ffn, _ = channel_mix_decode(lp, rmsnorm(x, lp["ffn_norm"], cfg.norm_eps),
                                    state["ffn_x"][i])
        x = x + ffn
    return _logits(params, x, cfg), state
