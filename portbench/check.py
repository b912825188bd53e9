"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of the
requests the window finished, drawn from the seed and holding the one with
the most served tokens, goes through the reference once: each prompt with
its served tokens, logits at every position that produced a served token.
The numbers compared are the widest gap by which a served token's logit lies
below the reference's best at that position (0 where greedy decoding agrees
with the reference) and the mean of that gap over the served tokens; a
cell's limits file says which it holds to a limit. Every request attempted
in the window has to have come back whole, too.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref


def pick(done: list[dict], k: int, seed: int) -> list[dict]:
    """k finished requests: the one with the most served tokens (the first
    such), and k - 1 more drawn from the seed."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: (len(done[i]["served"]), -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([seed, 2])
    take = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [done[longest]] + [done[rest[i]] for i in sorted(take)]


def logit_gaps(shape: dict, quant: dict, seed: int, device, sample: list[dict]) -> dict:
    """The sample's served tokens against the reference: ``max_logit_gap``,
    ``mean_logit_gap``, ``tokens_compared``, and the gaps' quantiles and the
    share of tokens that are not the reference's best (``stats``)."""
    seqs, positions = [], []
    for r in sample:
        p, s = r["prompt"], r["served"]
        seqs.append(torch.as_tensor(p + s[:-1], dtype=torch.long))
        positions.append(torch.arange(len(p) - 1, len(p) - 1 + len(s)))
    logits = ref.logits_at(shape, quant, seed, device, seqs, positions)
    gaps = []
    for lg, r in zip(logits, sample):
        served = torch.as_tensor(r["served"], dtype=torch.long, device=lg.device)
        gaps.append(lg.max(dim=-1).values - lg.gather(1, served[:, None])[:, 0])
    g = torch.cat(gaps).double().cpu()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64))
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "tokens_compared": len(g),
            "stats": {"p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
                      "not_best": float((g > 0).double().mean())}}
