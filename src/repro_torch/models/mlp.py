"""FFN block: dense SwiGLU with fused W1+W3 (counterpart of
``repro/models/mlp.py``; paper Alg. 2 line 12). MoE is not yet ported."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import linear, split_fused
from repro_torch.models.common import dense_init, swiglu


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             lead: tuple[int, ...] = ()) -> dict:
    dt = cfg.pdtype()
    f = d_ff or cfg.d_ff
    return {
        "w13": dense_init(gen, 2 * f, cfg.d_model, dt, lead),   # fused gate+up (C4)
        "w2": dense_init(gen, cfg.d_model, f, dt, lead),
    }


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    f = p["w2"].shape[-1]  # QuantizedTensor.shape is the logical shape
    gate, up = split_fused(linear(p["w13"], x), (f, f))
    return linear(p["w2"], swiglu(gate, up))
