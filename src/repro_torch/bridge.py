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
    """Random f32 weights in the reference ``init_lm`` layout (dense GQA
    decoder): N(0, 1/in) projections, N(0, 0.02^2) embeddings, and the
    reference's norms: ones, or for gemma2 (``plus_one`` norms, which
    store w - 1) zeros, with its ``post_att_norm``/``post_ffn_norm``.
    Stacked layer leaves are (L, out, in); a tied config has no
    ``classifier``. The draws are f32 whatever ``cfg.param_dtype`` says;
    the golden run uses an f32 config.

    ``norm_scale`` > 0 adds N(0, norm_scale^2) to every norm weight, drawn
    after all other leaves (so the other leaves do not change), for tests
    that must see the norm weights act (gemma2's + 1 included)."""
    rng = np.random.RandomState(seed)
    d, L, vp = cfg.d_model, cfg.num_layers, cfg.vocab_padded
    norm = np.zeros if cfg.gemma_norms else np.ones

    def normal(shape, scale):
        return (rng.standard_normal(shape).astype(np.float32) * np.float32(scale))

    def dense(out_dim, in_dim, lead=()):
        return normal((*lead, out_dim, in_dim), in_dim ** -0.5)

    params = {
        "embed": normal((vp, d), 0.02),
        "layers": {
            "att_norm": norm((L, d), np.float32),
            "attn": {"wqkv": dense(cfg.q_dim + 2 * cfg.kv_dim, d, (L,)),
                     "wo": dense(d, cfg.q_dim, (L,))},
            "ffn_norm": norm((L, d), np.float32),
            "mlp": {"w13": dense(2 * cfg.d_ff, d, (L,)),
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
    return params
