"""Speculative decoding: drafters, exact accept/reject and the verify step
(counterpart of ``repro/serving/spec.py``).

Decode streams every weight once a step. A verify step runs the current
token plus k-1 drafted candidates through one forward pass
(``models/transformer.lm_verify``), so every projection is one GQMM over
b·k rows that reads each weight block once, and the accepted prefix
advances a sequence by 1..k tokens.

- **Drafters** propose the candidates on the host. ``NgramDrafter`` (the
  default) continues the longest trailing n-gram seen earlier in the
  context: no weights. ``ModelDrafter`` runs a small registry model
  greedily. Both are deterministic: a point-mass proposal, which makes the
  acceptance rule exact.
- **``spec_accept``**: greedy keeps the run of drafts equal to the target
  argmax, which also gives the correction or bonus token, so greedy output
  equals vanilla decode. Top-p accepts draft d with probability p_target(d)
  and on rejection samples the target with d masked out. Its noise (the
  uniform accept draws and the Gumbel draw) is an argument, as in
  ``serving/sampling.py``.
- **``build_verify_step``**: the step the engine and both scheduler
  adapters capture as a program (``serving/graphs.py``): verify, accept,
  commit the accepted prefix (clamped to each row's remaining budget and
  its ``live`` flag), advance ``pos`` in place. Rejected rows change no
  cache bit, so rollback is the position arithmetic itself.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves
from repro_torch.models.common import NEG_INF
from repro_torch.serving.sampling import nucleus_mask, sampler_sig

__all__ = ["Drafter", "ModelDrafter", "NgramDrafter", "build_verify_step", "draft_chunk",
           "resolve_drafter", "spec_accept", "take_accepted"]


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

@runtime_checkable
class Drafter(Protocol):
    """Proposes k candidate continuations of a token context, on the host,
    deterministically: the acceptance rule treats the proposal as a point
    mass."""

    name: str

    def draft(self, tokens: Sequence[int], k: int) -> list[int]:
        """tokens -> exactly k proposed continuation token ids."""
        ...


class NgramDrafter:
    """Prompt-lookup drafter: no weights, no forward passes. Finds the most
    recent earlier occurrence of the context's trailing n-gram (longest n
    first, down to 1) and proposes the tokens that followed it; with no
    match it repeats the last token. Only the trailing ``window`` tokens are
    scanned, so the host's cost a step stays bounded on long generations."""

    name = "ngram"

    def __init__(self, max_n: int = 3, window: int = 512):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = max_n
        self.window = window

    def draft(self, tokens: Sequence[int], k: int) -> list[int]:
        toks = list(tokens)[-self.window:]
        if not toks:
            return [0] * k
        for n in range(min(self.max_n, len(toks) - 1), 0, -1):
            suffix = toks[-n:]
            # the most recent earlier occurrence wins
            for i in range(len(toks) - n - 1, -1, -1):
                if toks[i:i + n] == suffix:
                    cont = toks[i + n:i + n + k]
                    if cont:
                        return (cont + [toks[-1]] * (k - len(cont)))[:k]
        return [toks[-1]] * k


class ModelDrafter:
    """Greedy k-token drafts from a registry model with its own weights,
    through the port's own ``prefill`` and ``decode``, eagerly. Each call
    prefills the bucket-padded context and decodes k-1 greedy steps:
    O(context) work a call, paid for by the draft model being a fraction of
    the target."""

    def __init__(self, model, params, *, max_len: int = 4096):
        if not model.supports_lengths:
            raise ValueError(f"{model.cfg.arch_id}: ModelDrafter needs length-aware "
                             "prefill (decoder_lm families)")
        self.name = f"model:{model.cfg.arch_id}"
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = tree_leaves(params)[0].device

    @torch.inference_mode()
    def draft(self, tokens: Sequence[int], k: int) -> list[int]:
        from repro_torch.serving.core import bucket_length

        toks = list(tokens)[-self.max_len:]
        pad_len = bucket_length(len(toks))
        arr = torch.zeros((1, pad_len), dtype=torch.long)
        arr[0, :len(toks)] = torch.as_tensor(toks, dtype=torch.long)
        length = torch.tensor([len(toks)], device=self.device)
        logits, cache = self.model.prefill(
            self.params, {"tokens": arr.to(self.device), "lengths": length}, pad_len + k)
        tok = logits.argmax(-1)
        out = [tok]
        for i in range(k - 1):
            logits, cache = self.model.decode(self.params, tok, cache, length + i)
            tok = logits.argmax(-1)
            out.append(tok)
        return torch.stack(out, 1)[0].tolist()


def resolve_drafter(name: str | None, *, reduced: bool = False, seed: int = 0,
                    device: str | torch.device = "cuda") -> Drafter:
    """CLI-string drafter factory: ``"ngram"`` (the default) or
    ``"model:<arch-id>"`` (a ported registry model with fresh weights from
    ``seed`` on ``device``, a stand-in for a trained draft checkpoint)."""
    from repro_torch.models.registry import build, load_config

    if name is None or name == "ngram":
        return NgramDrafter()
    if name.startswith("model:"):
        cfg = load_config(name.split(":", 1)[1])
        model = build(cfg.reduced() if reduced else cfg)
        return ModelDrafter(model, model.init(seed=seed, device=device))
    raise ValueError(f"unknown drafter {name!r} (ngram or model:<arch-id>)")


# ---------------------------------------------------------------------------
# exact accept/reject
# ---------------------------------------------------------------------------

def spec_accept(logits: torch.Tensor, chunk: torch.Tensor, *, sampler: str = "greedy",
                sampler_kw=(), uniform: torch.Tensor | None = None,
                gumbel: torch.Tensor | None = None):
    """Accept/reject a drafted chunk against its verify logits.

    logits (b, k, V): row j is the target's next-token distribution after
    chunk token j. chunk (b, k) = [t0, d1, .., d_{k-1}]: draft d_{j+1} is
    tested against logits row j. Returns (out (b, k), n_out (b,)): the
    step's tokens are ``out[i, :n_out[i]]``, the accepted drafts and then
    one correction (greedy argmax, or a sample of the leftover
    distribution) or, when every draft survives, a bonus token from the
    last row. Top-p takes the reference's draws as arguments: ``uniform``
    (b, k-1), the accept draws (unused at k = 1), and ``gumbel`` (b, V), the
    categorical's noise."""
    b, k, v = logits.shape
    drafts = chunk[:, 1:]                                           # (b, k-1)
    ones = torch.ones((b,), dtype=torch.long, device=logits.device)
    if sampler == "greedy":
        tgt = torch.argmax(logits, dim=-1)                          # (b, k)
        if k == 1:
            return tgt, ones
        match = (tgt[:, :k - 1] == drafts).long()
        # tgt[:, j] == d_{j+1} for accepted j, and row n_acc is the
        # correction or bonus: out is the argmax matrix
        return tgt, torch.cumprod(match, dim=1).sum(dim=1) + 1
    if sampler != "top_p":
        raise ValueError(f"unknown sampler {sampler!r} for speculative accept")
    kw = dict(sampler_kw)
    p, temp = kw.pop("p", 0.9), kw.pop("temperature", 1.0)
    if kw:
        raise ValueError(f"top_p accept takes p/temperature, got {sorted(kw)}")
    lg = logits / temp
    filt = torch.where(nucleus_mask(lg, p), lg, NEG_INF)            # (b, k, V)
    if k == 1:
        return torch.argmax(gumbel + filt[:, 0], dim=-1)[:, None], ones
    probs = torch.softmax(filt, dim=-1)
    p_draft = torch.gather(probs[:, :k - 1], 2, drafts[..., None].long())[..., 0]
    n_acc = torch.cumprod((uniform < p_draft).long(), dim=1).sum(dim=1)
    rows = torch.arange(b, device=logits.device)
    sel = filt[rows, n_acc]                                         # (b, V)
    # rejection at row n_acc < k-1: the rejected draft leaves the nucleus
    # (the leftover distribution); full acceptance samples the last row
    rejected = n_acc < k - 1
    rej_tok = drafts[rows, torch.clamp(n_acc, max=k - 2)]
    vocab = torch.arange(v, device=logits.device)[None, :]
    sel = torch.where(rejected[:, None] & (vocab == rej_tok[:, None]), NEG_INF, sel)
    t_new = torch.argmax(gumbel + sel, dim=-1)
    out = torch.cat([drafts.long(), torch.zeros_like(ones)[:, None]], dim=1)
    return out.scatter_(1, n_acc[:, None], t_new[:, None]), n_acc + 1


# ---------------------------------------------------------------------------
# host-side bookkeeping (the engine's and the scheduling core's)
# ---------------------------------------------------------------------------

def draft_chunk(drafter: Drafter, tok, live, context_fn, k: int) -> np.ndarray:
    """The (B, k) verify chunk: column 0 is each row's newest (uncommitted)
    token; live rows get k-1 drafts from their token history
    (``context_fn(i) -> list[int]``); other rows keep their token."""
    chunk = np.repeat(np.asarray(tok, np.int64)[:, None], k, axis=1)
    for i in np.flatnonzero(live):
        chunk[i, 1:] = drafter.draft(context_fn(i), k - 1)
    return chunk


def take_accepted(out_row, n_out, remaining, eos, stats, k: int) -> list[int]:
    """One row's tokens after a verify step: clamp to the remaining budget,
    truncate at EOS, and count only the kept tokens in ``stats`` (drafts
    accepted past an EOS or the budget are discarded work). Returns the
    tokens to keep (ending with EOS when one fired)."""
    take = min(int(n_out), int(remaining))
    new = [int(t) for t in out_row[:take]]
    if eos is not None and eos in new:
        new = new[: new.index(eos) + 1]
    stats["drafted"] += k - 1
    stats["accepted"] += min(int(n_out) - 1, len(new))
    stats["generated"] += len(new)
    return new


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------

def build_verify_step(model, params, *, sampler: str = "greedy", sampler_kw=None,
                      paged: bool = False):
    """One speculative step as a function over static buffers, for
    ``GraphCache.program``: verify the chunk, accept/reject, commit the
    accepted prefix, advance positions, all in place.

    ``step(chunk, pos, live, remaining, cache, table=None, uniform=None,
    gumbel=None, last=None)``: ``chunk`` (b, k); ``pos`` (b,) advanced by
    each row's commit count ``min(n_out, remaining)`` where ``live``, else
    0, so the cache grows by exactly the tokens the host keeps; ``cache``
    the contiguous cache, or with ``paged`` the pool and its ``table``;
    ``uniform`` / ``gumbel`` top-p's noise; ``last`` (b, V), if given, takes
    each live row's logits that produced its final kept token (indexed by
    the budget-clamped count: EOS is host knowledge, so an EOS mid-chunk
    reads one row late, as in the reference). Returns (b, k + 1): ``out``
    then ``n_out``, one tensor so the host fetches a step in one transfer."""
    skw = sampler_sig(sampler_kw)

    def step(chunk, pos, live, remaining, cache, table=None, uniform=None, gumbel=None,
             last=None):
        if paged:
            logits, rows = model.verify_paged(params, chunk, cache, table, pos)
        else:
            logits, rows = model.verify(params, chunk, cache, pos)
        out, n_out = spec_accept(logits, chunk, sampler=sampler, sampler_kw=skw,
                                 uniform=uniform, gumbel=gumbel)
        n_commit = torch.where(live, torch.minimum(n_out, torch.clamp(remaining, min=0)), 0)
        if last is not None:
            idx = torch.clamp(torch.minimum(n_out, torch.clamp(remaining, min=1)) - 1, min=0)
            row = logits[torch.arange(logits.shape[0], device=logits.device), idx]
            last.copy_(torch.where(live[:, None], row, last))
        if paged:
            model.commit_verify_paged(cache, rows, table, pos, n_commit)
        else:
            model.commit_verify(cache, rows, pos, n_commit)
        pos.add_(n_commit)
        return torch.cat([out, n_out[:, None]], dim=1)

    return step
