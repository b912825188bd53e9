"""AdamW + cosine schedule + global-norm clipping (counterpart of
``repro/optim/adamw.py``).

Optimizer state is a tree shaped like the params (m, v, f32), so a
checkpoint keeps the reference's stacked (L, ...) leaves under ``opt/m/...``
and ``opt/v/...``. The arithmetic is the reference's, op for op in f32:
the clipped gradient is cast back to the gradient's dtype before the
update (for bf16 params that rounding is part of the result), decoupled
weight decay applies to leaves of two or more dimensions only, and the new
parameter is ``p.f32 - lr * update`` cast to p's dtype. ``apply`` is
functional: it returns new tensors and leaves its arguments as they were.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import tree_items, tree_map, tree_map_with_path


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(torch.float32))) for _, leaf in tree_items(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def init(params) -> AdamWState:
    """Zero moments shaped (and, for DTensor params, placed) like the params."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    step = torch.zeros((), dtype=torch.int32, device=tree_items(params)[0][1].device)
    return AdamWState(step=step, m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: AdamWState):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    return apply_clipped(cfg, params, grads, state, gnorm)


@torch.no_grad()
def apply_clipped(cfg: AdamWConfig, params, grads, state: AdamWState, gnorm: torch.Tensor):
    """The update of :func:`apply` on gradients already clipped (their
    global norm before clipping ``gnorm``): elementwise, so it runs as well
    on each rank's block of the params, gradients and moments."""
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * update).to(p.dtype), m, v

    out = {}
    flat_g, flat_m, flat_v = (dict(tree_items(t)) for t in (grads, state.m, state.v))
    for path, p in tree_items(params):
        out[path] = upd(p, flat_g[path], flat_m[path], flat_v[path])

    def pick(i):
        return tree_map_with_path(lambda path, _: out[path][i], params)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2)), metrics

