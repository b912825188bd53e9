"""Parameters across the package boundary, as nested dicts of numpy arrays.

The reference's parameters reach the port as nested dicts of numpy arrays
in the reference's tree layout. A quantized leaf arrives as a dict
``{"qvalues", "scales", "group_size", "fmt"}`` in any registered format:
int8, packed int4 (int8 bytes), packed int3 (uint8 bytes) or fp8. The
``ml_dtypes`` arrays numpy gets from JAX cross bit-exactly as their bit
patterns, bfloat16 as int16 and float8_e4m3fn as uint8, so this module
needs neither JAX nor ``ml_dtypes``.

``init_params_numpy`` draws weights in that same layout from a seeded
numpy ``RandomState``, whose stream numpy keeps fixed across versions; the
reference and the port can then run identical weights without either one
importing the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantizedTensor, get_format
from repro_torch.device import resolve_device

_QT_KEYS = {"qvalues", "scales", "group_size"}
# init_params_numpy draws a larger leaf in slices of at most this many
# values (numpy's f64 draw of a whole leaf would be twice its f32 size)
_DRAW_CHUNK = 1 << 24
# ml_dtypes types -> (the numpy type of their bit pattern, the torch type)
_BIT_CAST = {"bfloat16": (np.int16, torch.bfloat16),
             "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _BIT_CAST:
        bits_type, dtype = _BIT_CAST[a.dtype.name]
        bits = np.ascontiguousarray(a).view(bits_type).copy()
        return torch.from_numpy(bits).view(dtype).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the port's params on ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            if _QT_KEYS <= set(node):
                fmt = str(node.get("fmt", "int8"))
                qv = _to_tensor(node["qvalues"], dev)
                want = get_format(fmt).storage_dtype
                if qv.dtype != want:
                    raise TypeError(f"{fmt} qvalues must be stored as {want}, got {qv.dtype}")
                return QuantizedTensor(qv, _to_tensor(node["scales"], dev),
                                       int(node["group_size"]), fmt)
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)


def init_params_numpy(cfg: ModelConfig, seed: int, *, norm_scale: float = 0.0) -> dict:
    """Random f32 weights in the reference ``init_lm`` layout: N(0, 1/in)
    projections, N(0, 0.02^2) embeddings, and the reference's norms: ones,
    or for gemma2 (``plus_one`` norms, which store w - 1) zeros, with its
    ``post_att_norm``/``post_ffn_norm``. Stacked layer leaves are (L, out,
    in); a tied config has no ``classifier``. The draws are f32 whatever
    ``cfg.param_dtype`` says; the golden run uses an f32 config.

    An MLA config draws its attention leaves (``wdkv``, ``wukv``, ``wo``,
    then ``wq`` or ``wdq``/``wuq``; ``kv_norm``/``q_norm`` ones) where a GQA
    config draws ``wqkv``/``wo``; a MoE config its ``router_w`` (L, E, d),
    the experts' ``w13``/``w2`` (L, E, out, in) and its ``shared`` SwiGLU
    where a dense one draws ``w13``/``w2``. So the dense GQA configs' draws
    are those they always were. A large leaf is drawn a slice at a time
    (``_DRAW_CHUNK``), the same numbers as one draw (numpy's stream is
    sequential).

    The recurrent families and the encoder-decoder draw their own trees
    (``_rwkv_numpy``, ``_zamba_numpy``, ``_encdec_numpy``) with the
    reference's constants.

    ``norm_scale`` > 0 adds N(0, norm_scale^2) to every norm weight, drawn
    after all other leaves (so the other leaves do not change; MLA's
    ``kv_norm``/``q_norm`` last; a recurrent tree's norms in sorted path
    order; so an own tree's), for tests that must see the norm weights act
    (gemma2's + 1 included)."""
    rng = np.random.RandomState(seed)
    d, L, vp = cfg.d_model, cfg.num_layers, cfg.vocab_padded
    norm = np.zeros if cfg.gemma_norms else np.ones

    def normal(shape, scale):
        row = int(np.prod(shape[1:]))
        if row * shape[0] <= _DRAW_CHUNK or len(shape) < 2:
            return rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        out = np.empty(shape, np.float32)
        step = max(1, _DRAW_CHUNK // row)
        for i in range(0, shape[0], step):
            sub = (min(step, shape[0] - i), *shape[1:])
            out[i:i + step] = (normal(sub[1:], scale)[None] if row > _DRAW_CHUNK
                               else normal(sub, scale))
        return out

    def dense(out_dim, in_dim, lead=()):
        return normal((*lead, out_dim, in_dim), in_dim ** -0.5)

    if cfg.model_type in _OWN_TREES:
        params = _OWN_TREES[cfg.model_type](cfg, normal, dense)
        if norm_scale:
            _add_norm_noise(params, lambda shape: normal(shape, norm_scale))
        return params
    params = {
        "embed": normal((vp, d), 0.02),
        "layers": {
            "att_norm": norm((L, d), np.float32),
            "attn": _mla_numpy(cfg, dense) if cfg.mla else {
                "wqkv": dense(cfg.q_dim + 2 * cfg.kv_dim, d, (L,)),
                "wo": dense(d, cfg.q_dim, (L,))},
            "ffn_norm": norm((L, d), np.float32),
            "mlp": _moe_numpy(cfg, dense) if cfg.moe else {
                "w13": dense(2 * cfg.d_ff, d, (L,)),
                "w2": dense(d, cfg.d_ff, (L,))},
        },
        "final_norm": norm((d,), np.float32),
    }
    if not cfg.tie_embeddings:
        params["classifier"] = dense(vp, d)
    if cfg.gemma_norms:
        params["layers"]["post_att_norm"] = np.zeros((L, d), np.float32)
        params["layers"]["post_ffn_norm"] = np.zeros((L, d), np.float32)
    if norm_scale:
        layers = params["layers"]
        for name in sorted(k for k in layers if k.endswith("norm")):
            layers[name] = layers[name] + normal(layers[name].shape, norm_scale)
        params["final_norm"] = params["final_norm"] + normal((d,), norm_scale)
        at = layers["attn"]
        for name in sorted(k for k in at if k.endswith("norm")):
            at[name] = at[name] + normal(at[name].shape, norm_scale)
    return params


def _mla_numpy(cfg: ModelConfig, dense) -> dict:
    m, d, h, L = cfg.mla, cfg.d_model, cfg.num_heads, cfg.num_layers
    p = {"wdkv": dense(m.kv_lora_rank + m.qk_rope_dim, d, (L,)),
         "kv_norm": np.ones((L, m.kv_lora_rank), np.float32),
         "wukv": dense(h * (m.qk_nope_dim + m.v_head_dim), m.kv_lora_rank, (L,)),
         "wo": dense(d, h * m.v_head_dim, (L,))}
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    if m.q_lora_rank:
        p["wdq"] = dense(m.q_lora_rank, d, (L,))
        p["q_norm"] = np.ones((L, m.q_lora_rank), np.float32)
        p["wuq"] = dense(h * qk_dim, m.q_lora_rank, (L,))
    else:
        p["wq"] = dense(h * qk_dim, d, (L,))
    return p


def _moe_numpy(cfg: ModelConfig, dense) -> dict:
    m, d, L = cfg.moe, cfg.d_model, cfg.num_layers
    p = {"router_w": dense(m.num_experts, d, (L,)),
         "experts": {"w13": dense(2 * m.d_expert, d, (L, m.num_experts)),
                     "w2": dense(d, m.d_expert, (L, m.num_experts))}}
    if m.num_shared:
        f = m.d_expert * m.num_shared
        p["shared"] = {"w13": dense(2 * f, d, (L,)), "w2": dense(d, f, (L,))}
    return p


def _rwkv_numpy(cfg: ModelConfig, normal, dense) -> dict:
    """rwkv6's tree: the reference's constants (norms ones, mixes 0.5,
    ``decay_w0`` -6) and draws (the decay LoRA and mixing matrices N(0,
    1/in), ``bonus_u`` N(0, 0.1²)); embeddings, then the layers' drawn
    leaves in the reference's order, then the classifier."""
    d, f, L, vp = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_padded
    hd = cfg.resolved_head_dim
    embed = normal((vp, d), 0.02)
    layers = {"att_norm": np.ones((L, d), np.float32),
              **{m: np.full((L, d), 0.5, np.float32)
                 for m in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w")},
              "decay_w0": np.full((L, d), -6.0, np.float32),
              "decay_lora_a": dense(64, d, (L,)), "decay_lora_b": dense(d, 64, (L,)),
              "bonus_u": normal((L, d // hd, hd), 0.1)}
    for name in ("wr", "wk", "wv", "wg", "wout"):
        layers[name] = dense(d, d, (L,))
    layers.update({"ffn_norm": np.ones((L, d), np.float32),
                   "mix_ffn": np.full((L, d), 0.5, np.float32),
                   "wffr": dense(d, d, (L,)), "wff1": dense(f, d, (L,)),
                   "wff2": dense(d, f, (L,))})
    return {"embed": embed, "layers": layers, "final_norm": np.ones((d,), np.float32),
            "classifier": dense(vp, d)}


def _zamba_numpy(cfg: ModelConfig, normal, dense) -> dict:
    """zamba2's tree: Mamba2 layers (groups, per, ...) and, where
    num_layers is no multiple of shared_attn_every, (tail, ...); ``win`` and
    ``wout`` N(0, 1/in), ``conv_w`` N(0, 0.1²), ``a_log`` / ``dt_bias``
    zeros, ``d_skip`` and the norms ones; the shared GQA + SwiGLU block.
    Drawn in order: embeddings, the groups' Mamba2 layers, the shared
    block, the classifier, the tail."""
    d, vp, s = cfg.d_model, cfg.vocab_padded, cfg.ssm
    k = cfg.shared_attn_every
    groups, tail = cfg.num_layers // k, cfg.num_layers % k
    d_inner = s.expand * d
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    in_dim = 2 * d_inner + 2 * s.state_dim + nheads

    def mamba(lead):
        return {"norm": np.ones((*lead, d), np.float32),
                "mamba": {"win": dense(in_dim, d, lead),
                          "conv_w": normal((*lead, s.conv_kernel, conv_ch), 0.1),
                          "a_log": np.zeros((*lead, nheads), np.float32),
                          "dt_bias": np.zeros((*lead, nheads), np.float32),
                          "d_skip": np.ones((*lead, nheads), np.float32),
                          "gate_norm": np.ones((*lead, d_inner), np.float32),
                          "wout": dense(d, d_inner, lead)}}

    params = {"embed": normal((vp, d), 0.02), "mamba_layers": mamba((groups, k)),
              "shared": {"att_norm": np.ones((d,), np.float32),
                         "attn": {"wqkv": dense(cfg.q_dim + 2 * cfg.kv_dim, d),
                                  "wo": dense(d, cfg.q_dim)},
                         "ffn_norm": np.ones((d,), np.float32),
                         "mlp": {"w13": dense(2 * cfg.d_ff, d), "w2": dense(d, cfg.d_ff)}},
              "final_norm": np.ones((d,), np.float32), "classifier": dense(vp, d)}
    if tail:
        params["tail_layers"] = mamba((tail,))
    return params


def _encdec_numpy(cfg: ModelConfig, normal, dense) -> dict:
    """The encoder-decoder's tree: norms ones, projections N(0, 1/in).
    Drawn in order: embeddings, the encoder layers (wqkv, wo, w13, w2),
    the decoder layers (wqkv, wo, the cross attention's wq, wkv, wo, then
    w13, w2), the classifier."""
    d, vp = cfg.d_model, cfg.vocab_padded

    def layers(lead, cross: bool) -> dict:
        ones = np.ones((*lead, d), np.float32)
        out = {"att_norm": ones, "attn": {"wqkv": dense(cfg.q_dim + 2 * cfg.kv_dim, d, lead),
                                          "wo": dense(d, cfg.q_dim, lead)}}
        if cross:
            out["cross_norm"] = ones.copy()
            out["cross"] = {"wq": dense(cfg.q_dim, d, lead), "wkv": dense(2 * cfg.kv_dim, d, lead),
                            "wo": dense(d, cfg.q_dim, lead)}
        out["ffn_norm"] = ones.copy()
        out["mlp"] = {"w13": dense(2 * cfg.d_ff, d, lead), "w2": dense(d, cfg.d_ff, lead)}
        return out

    embed = normal((vp, d), 0.02)
    enc = layers((cfg.encoder_layers,), cross=False)
    dec = layers((cfg.num_layers,), cross=True)
    return {"embed": embed, "enc_layers": enc, "enc_norm": np.ones((d,), np.float32),
            "dec_layers": dec, "final_norm": np.ones((d,), np.float32),
            "classifier": dense(vp, d)}


_OWN_TREES = {"rwkv6": _rwkv_numpy, "zamba2": _zamba_numpy, "encdec": _encdec_numpy}


def _add_norm_noise(tree: dict, draw) -> None:
    """Add ``draw(shape)`` to every leaf whose key ends in "norm", in sorted
    path order, in place."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            _add_norm_noise(tree[key], draw)
        elif key.endswith("norm"):
            tree[key] = tree[key] + draw(tree[key].shape)
