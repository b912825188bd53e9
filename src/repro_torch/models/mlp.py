"""FFN blocks (counterpart of ``repro/models/mlp.py``): dense SwiGLU with
fused W1+W3 (paper Alg. 2 line 12) and the dense-dispatch MoE (dbrx: 16
experts top-4; deepseek-v2-lite: 64 top-6 and 2 shared)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import linear, quantize_input, split_fused
from repro_torch.models.common import dense_init, swiglu


# ---------------------------------------------------------------------------
# dense SwiGLU
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _stacked_init(gen: torch.Generator, out_dim: int, in_dim: int, dtype,
                  lead: tuple[int, ...]) -> torch.Tensor:
    """:func:`dense_init` of a (*lead, out, in) leaf drawn one (out, in)
    slice at a time, so the f32 draw of a large stacked leaf (dbrx's experts:
    16 x 21504 x 6144 a layer) never exists whole."""
    out = torch.empty((*lead, out_dim, in_dim), dtype=dtype, device=gen.device)
    flat = out.view(-1, out_dim, in_dim)
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, out_dim, in_dim, dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The reference's MoE tree: an f32 ``router_w`` (E, d), the experts'
    stacked ``w13`` (E, 2 d_expert, d) and ``w2`` (E, d, d_expert), and with
    ``num_shared`` a ``shared`` SwiGLU of num_shared * d_expert."""
    m = cfg.moe
    dt, d, e = cfg.pdtype(), cfg.d_model, m.num_experts
    p = {
        "router_w": dense_init(gen, e, d, torch.float32, lead),
        "experts": {"w13": _stacked_init(gen, 2 * m.d_expert, d, dt, (*lead, e)),
                    "w2": _stacked_init(gen, d, m.d_expert, dt, (*lead, e))},
    }
    if m.num_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=m.d_expert * m.num_shared, lead=lead)
    return p


def _router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,ed->bse", x.to(torch.float32), w.to(torch.float32))


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, *, by_column: bool = False
                ) -> torch.Tensor:
    """Dense-dispatch MoE, the reference's: every expert computes on every
    token and the top-k combine selects. x (b, s, d).

    The router runs in f32 on the float ``router_w``: softmax, top-k, the k
    probabilities renormalised by their sum taken left to right in
    descending order, and the combine weights (b, s, E) in x's dtype; the
    experts' outputs (E, b, s, d) are combined by the reference's
    ``ebsd,bse->bsd`` contraction in x's dtype, and the shared expert added.

    The experts run as a loop of ``linear`` calls, two GQMMs an expert with
    quantized weights: x is quantized once for every expert's ``w13`` (the
    reference's ``vmap`` with the input unbatched), each expert's SwiGLU
    output once for its ``w2``. ``by_column`` computes the router logits of
    each column x[:, j] apart, as a decode step of b rows computes them (a
    speculative verify chunk, whose rows must round as their decode steps
    do; every other step here is row by row)."""
    m = cfg.moe
    b, s, _ = x.shape
    if by_column and s > 1:
        logits = torch.cat([_router_logits(x[:, j:j + 1].contiguous(), p["router_w"])
                            for j in range(s)], dim=1)
    else:
        logits = _router_logits(x, p["router_w"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, m.top_k, dim=-1)               # descending
    total = top_p[..., 0]
    for j in range(1, m.top_k):
        total = total + top_p[..., j]
    top_p = top_p / total[..., None]
    combine = torch.zeros((b, s, m.num_experts), dtype=x.dtype, device=x.device)
    combine.scatter_(-1, top_idx, top_p.to(x.dtype))

    w13, w2 = p["experts"]["w13"], p["experts"]["w2"]
    xq = quantize_input(w13, x)
    outs = []
    for e in range(m.num_experts):
        gate, up = split_fused(linear(w13[e], x, xq), (m.d_expert, m.d_expert))
        outs.append(linear(w2[e], swiglu(gate, up)))
    y = torch.einsum("ebsd,bse->bsd", torch.stack(outs), combine)
    if m.num_shared:
        y = y + mlp_forward(p["shared"], x)
    return y


def moe_aux_loss(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (framework substrate, the
    reference's ``moe_aux_loss``; like the reference, ``lm_loss`` does not
    add it)."""
    m = cfg.moe
    probs = torch.softmax(_router_logits(x, p["router_w"]), dim=-1)
    top_idx = torch.topk(probs, m.top_k, dim=-1)[1]
    frac_tokens = torch.mean(
        torch.nn.functional.one_hot(top_idx, m.num_experts).to(torch.float32), dim=(0, 1, 2))
    frac_probs = torch.mean(probs, dim=(0, 1))
    return m.num_experts * torch.sum(frac_tokens * frac_probs)
