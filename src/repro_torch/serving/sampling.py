"""Token sampling (counterpart of ``repro/serving/sampling.py``).

Greedy only for now; top-p is a later slice."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(b, V) -> (b,) token ids; ties go to the first index, as in the
    reference's ``argmax``. The paper's evaluation setting (§V-C)."""
    return torch.argmax(logits, dim=-1)


def make_sampler(name: str):
    """sampler(logits) -> tokens."""
    if name == "greedy":
        return greedy
    if name == "top_p":
        raise NotImplementedError("the top_p sampler is not yet ported to repro_torch")
    raise ValueError(f"unknown sampler {name}")
