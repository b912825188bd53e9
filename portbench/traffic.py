"""The one traffic generator: a mix's parameter file in, a seed's requests out.

A mix (``portbench/traffic/<name>.json``) gives the entry it drives, the
number of requests in one pass and how they are grouped into calls, and the
prompt and output length distributions. Every seed gets the same (prompt
length, output length) pairs in the same order: lengths at fixed quantiles
of the distributions, paired and ordered by a fixed permutation. A
continuous batcher's schedule follows the order of its requests, so only a
fixed order gives every run the same work; the seed draws the token ids.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path

import numpy as np

PAIRING_SEED = 20240917      # fixes the pairing and the order of the lengths


@dataclasses.dataclass(frozen=True)
class Req:
    id: int
    tokens: list[int]
    max_new: int


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def quantile_lengths(dist: dict, n: int) -> list[int]:
    """n lengths at the quantiles (i + 1/2) / n of ``dist``: ``lognormal``
    (``median``, ``sigma``) or ``uniform``, rounded and clipped to
    [``min``, ``max``]."""
    lo, hi = dist["min"], dist["max"]
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if dist["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            x = dist["median"] * math.exp(dist["sigma"] * z)
        elif dist["dist"] == "uniform":
            x = lo + u * (hi - lo)
        else:
            raise ValueError(f"unknown length distribution {dist['dist']!r}")
        out.append(int(min(hi, max(lo, round(x)))))
    return out


def pairs(mix: dict) -> list[tuple[int, int]]:
    """The mix's (prompt length, output length) pairs in pass order, the same
    for every seed."""
    n = mix["requests"]
    prompts = quantile_lengths(mix["prompt"], n)
    outputs = quantile_lengths(mix["output"], n)
    rng = np.random.default_rng(PAIRING_SEED)
    pair, order = rng.permutation(n), rng.permutation(n)
    return [(prompts[i], outputs[pair[i]]) for i in order]


def requests(mix: dict, seed: int, vocab: int) -> list[Req]:
    """One pass of the mix for ``seed``: each prompt's token ids uniform over
    the vocabulary."""
    rng = np.random.default_rng([seed, 1])
    return [Req(i, rng.integers(0, vocab, size=p).tolist(), o)
            for i, (p, o) in enumerate(pairs(mix))]


def calls(mix: dict, reqs: list[Req]) -> list[list[Req]]:
    """The pass cut into calls of ``per_call`` requests."""
    k = mix["per_call"]
    return [reqs[i:i + k] for i in range(0, len(reqs), k)]
