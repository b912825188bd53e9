"""Token sampling (counterpart of ``repro/serving/sampling.py``): greedy and
nucleus (top-p).

Randomness is explicit. Where the reference draws ``jax.random.categorical``
(``argmax(logits + gumbel(key, shape))``), ``top_p`` here takes the Gumbel
noise as an argument, so a caller that passes the reference's own draw gets
the reference's token. On the serving path the noise comes from a
``torch.Generator`` on the engine's device, seeded from the caller's
``seed``, and is drawn into a program's static buffer before each replay
(``draw_noise``), outside the captured graph: a draw inside a capture would
tie the program to generator state the graph does not track.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models.common import NEG_INF

# static-buffer names a program's noise lives under (``draw_noise``)
UNIFORM, GUMBEL = "uniform", "gumbel"


def greedy(logits: torch.Tensor, gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """(b, V) -> (b,) token ids; ties go to the first index, as in the
    reference's ``argmax``. The paper's evaluation setting (§V-C). Takes
    (and ignores) ``gumbel`` so every sampler has one signature."""
    return torch.argmax(logits, dim=-1)


def nucleus_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Boolean mask of the smallest set whose probability mass reaches ``p``.

    The reference's sorted-space construction: keep sorted position i iff
    the mass before it (exclusive cumsum) is still < p, then scatter the
    mask back through the sort permutation. A value threshold would keep
    every token tied with the cutoff. The sort is the reference's: a stable
    ascending argsort reversed, so among tied logits the highest index
    comes first. The top token is always kept."""
    idx = torch.argsort(logits, dim=-1, stable=True).flip(-1)        # descending
    probs = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p           # exclusive mass
    return torch.empty_like(keep_sorted).scatter_(-1, idx, keep_sorted)


def top_p(logits: torch.Tensor, p: float = 0.9, temperature: float = 1.0, *,
          gumbel: torch.Tensor) -> torch.Tensor:
    """Nucleus sampling [Holtzman et al., 2020] (paper ref [15]): the
    reference's ``categorical`` over the filtered logits, with its Gumbel
    draw ``gumbel`` (logits' shape) passed in."""
    logits = logits / temperature
    filtered = torch.where(nucleus_mask(logits, p), logits, NEG_INF)
    return torch.argmax(gumbel + filtered, dim=-1)


def sampler_sig(sampler_kw) -> tuple:
    """Canonical hashable form of a sampler-kwargs mapping, shared by every
    program key (``generate``, the schedulers) so the normalization cannot
    drift between call sites."""
    return tuple(sorted(dict(sampler_kw or {}).items()))


def make_sampler(name: str, **kw):
    """sampler(logits, gumbel=None) -> tokens. ``kw`` (p / temperature for
    top_p) is reachable end to end: ``generate``, ``serve_ragged`` and the
    schedulers take ``sampler_kw``, and the serve CLI exposes --top-p /
    --temperature."""
    if name == "greedy":
        if kw:
            raise ValueError(f"greedy sampler takes no kwargs, got {sorted(kw)}")
        return greedy
    if name == "top_p":
        return functools.partial(top_p, **kw)
    raise ValueError(f"unknown sampler {name}")


def needs_noise(sampler: str) -> bool:
    """Whether ``sampler`` draws noise (a program then carries noise buffers)."""
    return sampler != "greedy"


def fill_gumbel(buf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Gumbel(0, 1) noise into ``buf`` in place, as the reference draws it:
    -log(-log(u)) with u uniform on [tiny, 1)."""
    buf.uniform_(torch.finfo(buf.dtype).tiny, 1.0, generator=gen)
    return buf.log_().neg_().log_().neg_()


def draw_noise(inputs: dict, gen: torch.Generator) -> None:
    """Fill a program's noise buffers (``UNIFORM``, ``GUMBEL``) from ``gen``,
    in place, before its run."""
    if UNIFORM in inputs:
        inputs[UNIFORM].uniform_(generator=gen)
    if GUMBEL in inputs:
        fill_gumbel(inputs[GUMBEL], gen)
