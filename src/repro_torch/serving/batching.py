"""Variable-length request batching: front ends over the scheduling core
(counterpart of ``repro/serving/batching.py``).

The serving modes, all length-aware:

- **bucketed**: requests are right-padded to power-of-two buckets and each
  bucket runs one ``InferenceEngine.generate`` with the true lengths, so a
  padded row decodes exactly like its unpadded self; a recurrent family
  (no ragged lengths) groups by exact length instead. The encoder-decoder
  resolves here and is refused: a request carries no frames.
- **continuous** (``SlotScheduler``): a fixed-width decode batch of slots
  fed by the scheduling core (serving/core.py) over per-slot ``cache_len``
  cache rows (``ContiguousAdapter``) or per-slot recurrent state
  (``RecurrentAdapter``). Decode runs in rounds of ``chunk``
  steps between admission points; a slot that finishes mid-round idles,
  token and position frozen, until the round ends.
- **paged** (``PagedScheduler``, serving/paged.py): the block-pool KV cache
  behind the same core loop, with block reclaim and re-admission at the
  step a slot finishes. Token-identical greedy outputs to continuous.
  ``serve_ragged`` prefers it where the family supports it.

``sampler_kw`` reaches the sampler (top-p's p and temperature) and ``seed``
its noise generator in every mode. ``spec_k`` makes the continuous and paged
schedulers speculative (serving/spec.py); bucketed mode refuses it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence

import numpy as np

from repro_torch.core import flags
from repro_torch.serving.core import (
    ContiguousAdapter,
    RecurrentAdapter,
    Request,
    Response,
    SchedulerCore,
    bucket_length,
    finalize_tokens,
    make_response,
    pad_bucket,
)
from repro_torch.serving.paged import serve_paged
from repro_torch.serving.sampling import sampler_sig

__all__ = [
    "Request",
    "Response",
    "SlotScheduler",
    "bucket_length",
    "finalize_tokens",
    "make_response",
    "pad_bucket",
    "resolve_mode",
    "serve_bucketed",
    "serve_continuous",
    "serve_ragged",
    "slot_scheduler",
    "valid_modes",
]


# ---------------------------------------------------------------------------
# bucketed mode
# ---------------------------------------------------------------------------

def serve_bucketed(engine, requests: Sequence[Request], max_new_tokens: int, *,
                   sampler: str = "greedy", sampler_kw=None, seed: int = 0) -> list[Response]:
    """Bucket requests, generate per bucket, reassemble in arrival order.
    An encoder-decoder (the ``frames`` frontend) is refused: a ``Request``
    carries tokens only, so its encoder would get no frames (the reference
    fails here with ``KeyError: 'frames'``)."""
    if engine.cfg.frontend == "frames":
        raise ValueError(
            f"{engine.cfg.arch_id}: the bucketed path hands generate only the requests' tokens, "
            "and the encoder needs batch['frames'] (a Request carries none; the reference "
            "fails here with KeyError: 'frames'); call InferenceEngine.generate with frames")
    ragged = engine.model.supports_lengths
    eos = engine.eos_id
    buckets: dict[int, list[Request]] = defaultdict(list)
    for r in requests:
        n = len(r.tokens)
        buckets[bucket_length(n) if ragged else n].append(r)

    out: dict[int, Response] = {}
    for length in sorted(buckets):
        reqs = buckets[length]
        toks, lens = pad_bucket(reqs, length)
        budgets = [r.max_new if r.max_new is not None else max_new_tokens for r in reqs]
        # one generate per bucket runs to the bucket's longest budget; rows
        # with smaller budgets are decoded past their end and trimmed
        # a noise stream of its own per bucket (seed + length): one shared seed
        # would give every bucket the same draws a step
        res = engine.generate({"tokens": toks}, max(budgets), sampler=sampler,
                              sampler_kw=sampler_kw, seed=seed + length,
                              lengths=lens if ragged else None)
        gen = np.asarray(res.tokens)
        for i, r in enumerate(reqs):
            out[r.id] = make_response(r, [int(t) for t in gen[i, : budgets[i]]],
                                      budgets[i], eos)
    return [out[r.id] for r in requests]


# ---------------------------------------------------------------------------
# continuous mode
# ---------------------------------------------------------------------------

class SlotScheduler:
    """Slot-based continuous batching over one engine: the scheduling-core
    loop behind a ``ContiguousAdapter`` (decoder_lm: per-slot ``cache_len``
    cache rows) or a ``RecurrentAdapter`` (``cache_kind="state"``: O(1)
    per-slot recurrent state, exact-length admission groups).
    Responses always hold exactly the request's budget of tokens; sequences
    that hit EOS early are padded with EOS."""

    def __init__(self, engine, *, slots: int = 4, chunk: int = 4, sampler: str = "greedy",
                 sampler_kw=None, spec_k: int | None = None, drafter=None):
        if engine.model.cache_kind == "state":
            adapter = RecurrentAdapter(engine)
        elif engine.model.supports_lengths:
            adapter = ContiguousAdapter(engine)
        else:
            raise ValueError(
                f"{engine.cfg.arch_id}: continuous batching needs length-aware prefill "
                "(decoder_lm families) or O(1) per-slot recurrent state "
                "(cache_kind='state' families)")
        self.engine = engine
        self.adapter = adapter
        self._core = SchedulerCore(engine, self.adapter, slots=slots, chunk=chunk,
                                   sampler=sampler, sampler_kw=sampler_kw, spec_k=spec_k,
                                   drafter=drafter)
        self.slots = slots
        self.chunk = chunk
        self.spec_k = spec_k
        self.last_rounds = 0           # decode rounds of the last serve
        self.last_decode_steps = 0     # decode forward passes of the last serve
        self.last_spec_stats = None    # speculative accounting of the last serve

    def serve(self, requests: Sequence[Request], max_new_tokens: int, *,
              seed: int = 0) -> list[Response]:
        out = self._core.serve(requests, max_new_tokens, seed=seed)
        self.last_rounds = self._core.rounds
        self.last_decode_steps = self._core.decode_steps
        self.last_spec_stats = self._core.last_spec_stats
        return out


def slot_scheduler(engine, *, sampler: str = "greedy", sampler_kw=None, slots: int = 4,
                   chunk: int = 4, spec_k: int | None = None, drafter=None) -> SlotScheduler:
    """The engine's cached ``SlotScheduler`` for these settings, the one
    ``serve_continuous`` serves through (its ``last_*`` fields report that serve)."""
    cache = getattr(engine, "_slot_schedulers", None)
    if cache is None:
        cache = engine._slot_schedulers = {}
    sig = (slots, chunk, sampler, sampler_sig(sampler_kw), spec_k,
           id(drafter) if drafter is not None else None)
    if sig not in cache:
        cache[sig] = SlotScheduler(engine, slots=slots, chunk=chunk, sampler=sampler,
                                   sampler_kw=sampler_kw, spec_k=spec_k, drafter=drafter)
    return cache[sig]


def serve_continuous(engine, requests: Sequence[Request], max_new_tokens: int, *,
                     sampler: str = "greedy", sampler_kw=None, seed: int = 0, slots: int = 4,
                     chunk: int = 4, spec_k: int | None = None,
                     drafter=None) -> list[Response]:
    """Continuous batching through a per-engine cached ``SlotScheduler``."""
    return slot_scheduler(engine, sampler=sampler, sampler_kw=sampler_kw, slots=slots,
                          chunk=chunk, spec_k=spec_k, drafter=drafter).serve(
        requests, max_new_tokens, seed=seed)


def valid_modes(model) -> list[str]:
    """Serving modes the family can run, preferred first."""
    modes = []
    if model.supports_paged:
        modes.append("paged")
    if model.supports_lengths or model.cache_kind == "state":
        modes.append("continuous")
    modes.append("bucketed")
    return modes


def resolve_mode(engine, mode: str) -> str:
    """Capability dispatch for every front end (``serve_ragged``, the serve
    CLI): ``auto`` resolves to the family's preferred mode (paged, then
    continuous, then bucketed); an explicit mode is validated, and the
    error lists the modes valid for the arch."""
    ok = valid_modes(engine.model)
    if mode != "auto":
        if mode not in ("paged", "continuous", "bucketed"):
            raise ValueError(f"unknown serving mode {mode!r}; valid modes for "
                             f"{engine.cfg.arch_id}: {', '.join(ok)} (or 'auto')")
        if mode not in ok:
            raise ValueError(f"{engine.cfg.arch_id} does not support mode={mode!r}; "
                             f"valid modes: {', '.join(ok)} (or 'auto')")
        return mode
    # the paged pool keeps the base float KV layout; under the kvt/int8 cache
    # flags auto resolves to the contiguous scheduler, whose decode paths
    # support those layouts
    if ok[0] == "paged" and (flags.get("kvt_cache_layout") or flags.get("int8_kv_cache")):
        return ok[1]
    return ok[0]


def serve_ragged(engine, requests: Sequence[Request], max_new_tokens: int, *,
                 sampler: str = "greedy", sampler_kw=None, seed: int = 0, mode: str = "auto",
                 slots: int = 4, chunk: int = 4, block_size: int = 8,
                 num_blocks: int | None = None, spec_k: int | None = None,
                 drafter=None) -> list[Response]:
    """Serve a ragged request set; responses come back in arrival order.

    mode="paged" runs the block-pool scheduler (serving/paged.py),
    mode="continuous" the slot scheduler, mode="bucketed" the per-bucket
    generate loop; mode="auto" prefers paged, then continuous. ``spec_k``
    >= 2 makes the paged and continuous schedulers speculative: each round
    verifies spec_k candidate tokens a slot in one forward pass
    (serving/spec.py; ``drafter`` defaults to the n-gram drafter)."""
    if not requests:
        return []
    mode = resolve_mode(engine, mode)
    if spec_k is not None and mode == "bucketed":
        raise ValueError("speculative decoding needs the continuous or paged scheduler "
                         f"(resolved mode is 'bucketed' for {engine.cfg.arch_id})")
    kw = dict(sampler=sampler, sampler_kw=sampler_kw, seed=seed)
    if mode == "paged":
        return serve_paged(engine, requests, max_new_tokens, slots=slots, chunk=chunk,
                           block_size=block_size, num_blocks=num_blocks, spec_k=spec_k,
                           drafter=drafter, **kw)
    if mode == "continuous":
        return serve_continuous(engine, requests, max_new_tokens, slots=slots, chunk=chunk,
                                spec_k=spec_k, drafter=drafter, **kw)
    return serve_bucketed(engine, requests, max_new_tokens, **kw)
