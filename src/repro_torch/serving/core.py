"""The scheduling core: one serving loop, pluggable per-slot cache adapters
(counterpart of ``repro/serving/core.py``).

Every continuous-batching mode is the same host loop: validate, admit
pending requests into fixed decode slots (one batched prefill per admission
group), decode in rounds, finish slots at EOS or budget, and return
Responses in arrival order. What differs between modes is only how a slot's
decode state is laid out and addressed:

- ``ContiguousAdapter``: one ``cache_len``-wide KV row per slot, batch on
  axis 1 of every leaf.
- ``PagedAdapter`` (serving/paged.py): a ``BlockPool`` of fixed-size KV
  blocks behind per-slot block tables; admission is reservation-gated and
  blocks are allocated on demand and reclaimed the step a slot finishes.
- ``RecurrentAdapter``: O(1) per-slot recurrent state (rwkv6, zamba2's
  SSM backbone): admission groups by exact prompt length and continuous
  batching is a state scatter, with no paging and, for a fully O(1)
  family, no cache capacity to validate.

``SchedulerCore`` owns the queue, the slots, the budgets and the Response
finalization; adapters own the device work, as captured programs
(``serving/graphs.py``, the reference's jitted prefill and decode rounds):
a prefill that scatters its rows into the slots' cache, one program per
(group size, bucket length), and a decode step replayed once per step of a
round, over static buffers (token, position, ``live``, the cache) that
outlive a serve. Adapters return device tensors and the core makes the
host transfers: one per admission wave (the first tokens) and one per
decode round (the round's step count and tokens). Positions advance on the
host by the round's step count, so they never cross back.

With ``spec_k`` a round is one speculative verify step instead
(``serving/spec.py``): the core drafts on the host from each slot's token
history, the adapter replays its captured verify program
(``verify_round``), and one transfer brings the chunk's tokens and
counts; positions advance on the host by each slot's commit count, as the
program advanced them on the device. Top-p draws its noise from a
generator on the engine's device seeded with the serve's ``seed``, into
the programs' noise buffers before each replay.

With ``sanitize`` (analysis/sanitizer.py; by default the engine's setting)
the core calls the repro-san hooks at the reference's points: admission,
each prefill group, each finish (after ``adapter.on_finish``), before and
after every decode or verify round, and at the end of the serve. The
sanitizer reads and poisons the adapter's static cache in place
(``CacheAdapter.cache``), between replays, with one device read a round.

While spans are recorded (``serving/spans.py``) the loop opens, per call,
``serve``; per admission wave ``admit``, a ``prefill`` per group and
``prefill.readback``; per round ``round.prepare``, ``round.replay``,
``round.readback`` and ``round.commit``; and at each finish it adds the
request's ``request`` span. Off, each site reads one flag.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis.sanitizer import Sanitizer
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.serving import spans
from repro_torch.serving.sampling import (
    GUMBEL,
    UNIFORM,
    draw_noise,
    make_sampler,
    needs_noise,
    sampler_sig,
)
from repro_torch.serving.spec import NgramDrafter, build_verify_step, draft_chunk, take_accepted

__all__ = [
    "CacheAdapter",
    "ContiguousAdapter",
    "RecurrentAdapter",
    "Request",
    "Response",
    "SchedulerCore",
    "bucket_length",
    "finalize_tokens",
    "make_response",
    "pad_bucket",
]


@dataclasses.dataclass
class Request:
    id: int
    tokens: list[int]
    # per-request decode budget; None falls back to the serve call's
    # max_new_tokens
    max_new: int | None = None


@dataclasses.dataclass
class Response:
    id: int
    tokens: np.ndarray
    # true generated length: tokens[:length] are real, the rest is padding
    # (EOS, or 0 when the engine has no eos_id)
    length: int | None = None


def finalize_tokens(toks: list[int], budget: int, eos: int | None):
    """Trim at EOS, pad to ``budget``; returns (tokens (budget,), true length).
    ``length`` counts the real generated tokens, the EOS included."""
    t = toks[:budget]
    if eos is not None and eos in t:
        t = t[: t.index(eos) + 1]
    length = len(t)
    t = t + [eos if eos is not None else 0] * (budget - length)
    return np.asarray(t, np.int32), length


def make_response(req: Request, toks: list[int], budget: int, eos: int | None) -> Response:
    """The one Response construction path of every serving mode: trim at
    EOS, pad to the request's budget, carry the true generated length."""
    tokens, length = finalize_tokens(toks, budget, eos)
    return Response(id=req.id, tokens=tokens, length=length)


def bucket_length(n: int, *, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_bucket(reqs: Sequence[Request], length: int, pad_id: int = 0):
    """Right-pad to ``length``; returns (tokens (b, length), true lengths)."""
    toks = np.full((len(reqs), length), pad_id, np.int64)
    lens = np.zeros((len(reqs),), np.int64)
    for i, r in enumerate(reqs):
        toks[i, : len(r.tokens)] = r.tokens
        lens[i] = len(r.tokens)
    return toks, lens


# ---------------------------------------------------------------------------
# cache adapters
# ---------------------------------------------------------------------------

class CacheAdapter:
    """Per-slot cache policy behind ``SchedulerCore``. The verbs map onto the
    loop as:

      alloc    ``can_admit`` / ``on_admit``  (paged: reservation-gated block
               allocation; contiguous: a free slot is the allocation)
      insert   ``prefill_insert``            (batched prefill rows scattered
               into the admitted slots, one program)
      commit   ``decode_round`` / ``verify_round``  (advance the cache in
               place)
      free     ``on_finish``                 (paged: blocks back to the pool,
               table row sunk)
      snapshot ``snapshot``                  (host copy of per-slot state,
               for preemption and debugging)

    The adapter owns its cache: static buffers that outlive a serve
    (``cache``).
    ``prefill_insert`` and ``decode_round`` return device tensors; the core
    makes the host transfers."""

    kind: str = "abstract"
    spec_capable: bool = False

    def bind(self, core) -> None:
        """Attach to a core."""
        raise NotImplementedError

    def validate(self, requests, budget, slack: int = 0) -> None:
        """Reject requests that could never be served (capacity/layout);
        ``slack`` is the speculative chunk's extra cache columns."""

    def begin_serve(self) -> None:
        """Reset the static cache (plus any host-side pool state)."""
        raise NotImplementedError

    def _state(self) -> dict:
        """The static buffers: the round state and the ``cache``."""
        raise NotImplementedError

    def cache(self) -> dict:
        """The static device cache the adapter's programs read and write in
        place (the sanitizer's view of it)."""
        return self._state()["cache"]

    def can_admit(self, r: Request, budget: int) -> bool:
        return True

    def on_admit(self, s: int, r: Request, budget: int) -> None:
        """Per-slot allocation at admission (paged: prompt blocks + table)."""

    def group_len(self, n: int) -> int:
        """Padded prefill length for an ``n``-token prompt; admission groups
        share one batched prefill per distinct value."""
        raise NotImplementedError

    def prefill_insert(self, params, toks: np.ndarray, lens: np.ndarray, group,
                       length: int) -> torch.Tensor:
        """Batched prefill of ``group``'s prompts (right-padded to
        ``length``), its rows scattered into the group's slots; returns the
        greedy first tokens (a device copy)."""
        raise NotImplementedError

    def before_round(self, pos, live) -> None:
        """Pre-round host bookkeeping (paged: on-demand block growth)."""

    def check_positions(self, pos, live) -> None:
        """Assert live positions are addressable (cache edge, table edge)."""

    def round_steps(self, live: np.ndarray, remaining: np.ndarray) -> int:
        """Decode steps of the next round, from the host's budgets."""
        return self.core.chunk

    def decode_round(self, params, tok: np.ndarray, pos: np.ndarray, live: np.ndarray,
                     steps: int):
        """``steps`` decode steps from the host's tok/pos/live -> (toks
        (steps, b), n (1,)), both on the device: the round's tokens, of which
        the first n are real. Frozen slots (``live`` False) keep their token
        and position."""
        raise NotImplementedError

    def verify_round(self, params, chunk: np.ndarray, pos: np.ndarray, live: np.ndarray,
                     remaining: np.ndarray) -> torch.Tensor:
        """One speculative verify step of the host's chunk (B, k) -> (B, k + 1)
        on the device: each slot's ``out`` then ``n_out``
        (``spec.build_verify_step``). Only ``spec_capable`` adapters have it."""
        raise NotImplementedError(f"{self.kind}: no speculative verify path")

    def on_finish(self, s: int) -> None:
        """Free slot ``s``'s allocation (the core froze its tok/pos)."""

    def end_serve(self) -> None:
        """Post-serve bookkeeping (paged: pool high-water accounting)."""

    def snapshot(self, slots):
        """Host copy of the per-slot cache state for ``slots``."""
        raise NotImplementedError

    def san_state(self) -> dict:
        """repro-san registration (analysis/sanitizer.py): the adapter's host
        allocator state as ``{"pool": BlockPool | None, "table": block-table
        ndarray | None}``. Every concrete adapter defines this in its own
        body (the ``adapter-lifecycle`` checker holds it to that) so the
        shadow tracker can mirror whatever the adapter allocates."""
        raise NotImplementedError(f"{self.kind}: adapter registers no "
                                  "sanitizer state (san_state)")


def noise_buffer(engine, rows: int) -> dict:
    """A sampler's Gumbel buffer (rows, V) under its ``draw_noise`` name."""
    return {GUMBEL: torch.zeros((rows, engine.cfg.vocab_padded), dtype=torch.float32,
                                device=engine.device)}


def round_state(engine, slots: int, chunk: int, cache: dict, noise: bool = False) -> dict:
    """Static round buffers: token, position and ``live`` per slot, the EOS
    ``stopped`` flag, the step count ``n``, the round's tokens (chunk, slots),
    ``cache``, and with ``noise`` the sampler's Gumbel buffer."""
    dev = engine.device
    return {"tok": torch.zeros((slots,), dtype=torch.long, device=dev),
            "pos": torch.zeros((slots,), dtype=torch.long, device=dev),
            "live": torch.zeros((slots,), dtype=torch.bool, device=dev),
            "stopped": torch.zeros((1,), dtype=torch.bool, device=dev),
            "n": torch.zeros((1,), dtype=torch.long, device=dev),
            "toks": torch.zeros((chunk, slots), dtype=torch.long, device=dev),
            "cache": cache, **(noise_buffer(engine, slots) if noise else {})}


def replay_round(prog, st: dict, tok, pos, live, steps: int, gen: torch.Generator, **extra):
    """Load the host's tok/pos/live (and ``extra`` inputs) into ``prog``'s
    static buffers, replay its one-step program ``steps`` times (drawing
    the sampler's noise from ``gen`` before each) and keep each step's
    tokens; returns (toks (steps, b), n) on the device."""
    prog.load(tok=tok, pos=pos, live=live, stopped=False, n=0, **extra)
    for i in range(steps):
        draw_noise(prog.inputs, gen)
        prog.replay()
        st["toks"][i] = st["tok"]
    return st["toks"][:steps], st["n"]


def verify_inputs(engine, rows: int, k: int, sampler: str, cache: dict, **extra) -> dict:
    """A verify program's static buffers (``spec.build_verify_step``): the
    chunk (rows, k), position, ``live`` and remaining budget per row,
    ``cache``, for a noise-drawing sampler its accept draws and Gumbel
    buffer, then ``extra`` (the paged table; buffers shared with other
    programs)."""
    dev = engine.device
    ins = {"chunk": torch.zeros((rows, k), dtype=torch.long, device=dev),
           "pos": torch.zeros((rows,), dtype=torch.long, device=dev),
           "live": torch.zeros((rows,), dtype=torch.bool, device=dev),
           "remaining": torch.zeros((rows,), dtype=torch.long, device=dev),
           "cache": cache}
    if needs_noise(sampler):
        ins[UNIFORM] = torch.zeros((rows, k - 1), dtype=torch.float32, device=dev)
        ins.update(noise_buffer(engine, rows))
    return {**ins, **extra}


def replay_verify(prog, gen: torch.Generator, chunk, pos, live, remaining, **extra
                  ) -> torch.Tensor:
    """Load the host's chunk, positions, ``live`` and budgets (and ``extra``
    inputs), draw the noise, replay the verify program once; returns its
    (slots, k + 1) output on the device."""
    prog.load(chunk=chunk, pos=pos, live=live, remaining=remaining, **extra)
    draw_noise(prog.inputs, gen)
    return prog.replay()


class ContiguousAdapter(CacheAdapter):
    """One ``cache_len``-wide cache row per slot, batch on axis 1 of every
    leaf (``Model.insert_slots`` / ``Model.gather_slots``); live positions
    are bounded by ``cache_len``."""

    kind = "contiguous"
    spec_capable = True

    def __init__(self, engine):
        if not engine.model.supports_lengths:
            raise ValueError(
                f"{engine.cfg.arch_id}: continuous batching needs length-aware "
                "prefill and per-request decode positions (decoder_lm families)")
        self.engine = engine

    def bind(self, core):
        self.core = core
        self._key = (core.slots, core.chunk, self.engine.cache_len, core.sampler)
        if core.spec_k is not None:
            self._verify_step = build_verify_step(
                self.engine.model, self.engine.params, sampler=core.sampler[0],
                sampler_kw=dict(core.sampler[1]))

    def _state(self) -> dict:
        engine, slots = self.engine, self.core.slots
        return engine.graphs.state("contiguous", self._key, lambda: round_state(
            engine, slots, self.core.chunk,
            engine.model.init_cache(slots, engine.cache_len, engine.cfg.cdtype(),
                                    engine.device), needs_noise(self.core.sampler[0])))

    def validate(self, requests, budget, slack=0):
        cache_len = self.engine.cache_len
        for r in requests:
            need = max(bucket_length(len(r.tokens)), len(r.tokens) + budget(r) + slack)
            if need > cache_len:
                raise ValueError(
                    f"request {r.id}: len={len(r.tokens)} + max_new={budget(r)}"
                    + (f" + spec_k={slack}" if slack else "")
                    + f" needs {need} cache slots but cache_len={cache_len}")

    def begin_serve(self):
        for leaf in tree_leaves(self._state()["cache"]):
            leaf.zero_()

    def group_len(self, n):
        return bucket_length(n)

    def prefill_insert(self, params, toks, lens, group, length):
        st, model, sample = self._state(), self.engine.model, self.core.sample
        cache_len, bg, dev = self.engine.cache_len, len(group), self.engine.device

        def prefill(tokens, lengths, slots, cache, gumbel=None):
            logits, rows = model.prefill(params, {"tokens": tokens, "lengths": lengths},
                                         cache_len)
            model.insert_slots(cache, rows, slots)
            return sample(logits, gumbel=gumbel)

        prog = self.engine.graphs.program(
            "contiguous.prefill", self._key + (bg, length), prefill, lambda: {
                "tokens": torch.zeros((bg, length), dtype=torch.long, device=dev),
                "lengths": torch.full((bg,), length, dtype=torch.long, device=dev),
                "slots": torch.arange(bg, device=dev), "cache": st["cache"],
                **(noise_buffer(self.engine, bg) if GUMBEL in st else {})})
        prog.load(tokens=toks, lengths=lens, slots=np.asarray([s for s, _ in group]))
        draw_noise(prog.inputs, self.core.gen)
        return prog.run()

    def check_positions(self, pos, live):
        cache_len = self.engine.cache_len
        assert not live.any() or int(pos[live].max()) < cache_len, (
            f"live slot position escaped the cache: {pos[live]} >= cache_len={cache_len}")

    def decode_round(self, params, tok, pos, live, steps):
        # chunk rounds run full length; a slot that finishes mid-chunk idles
        # frozen to the round's end, and budgets are trimmed on the host
        st, model, sample = self._state(), self.engine.model, self.core.sample

        def step(tok, pos, live, stopped, n, cache, gumbel=None):
            logits, _ = model.decode(params, tok, cache, pos)
            tok.copy_(torch.where(live, sample(logits, gumbel=gumbel), tok))
            pos.copy_(torch.where(live, pos + 1, pos))
            n.add_(1)

        names = ("tok", "pos", "live", "stopped", "n", "cache") + (GUMBEL,) * (GUMBEL in st)
        prog = self.engine.graphs.program("contiguous.decode", self._key, step,
                                          lambda: {k: st[k] for k in names})
        return replay_round(prog, st, tok, pos, live, steps, self.core.gen)

    def verify_round(self, params, chunk, pos, live, remaining):
        # the step closes over engine.params (bind): the tree the core passes
        core, st = self.core, self._state()
        prog = self.engine.graphs.program(
            "contiguous.verify", self._key + (core.spec_k,), self._verify_step,
            lambda: verify_inputs(self.engine, core.slots, core.spec_k, core.sampler[0],
                                  st["cache"]))
        return replay_verify(prog, core.gen, chunk, pos, live, remaining)

    def snapshot(self, slots):
        """The slots' cache rows (``Model.gather_slots``), copied to the host."""
        san = self.core.sanitizer
        if san is not None:
            san.on_snapshot(slots)
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.long).to(self.engine.device)
        rows = self.engine.model.gather_slots(self.cache(), idx)
        return tree_map(lambda x: x.to("cpu", copy=True), rows)

    def san_state(self):
        # slot rows are the allocation: no pool, no table
        return {"pool": None, "table": None}


class RecurrentAdapter(ContiguousAdapter):
    """Slot-state continuous batching for the recurrent families (rwkv6,
    zamba2's SSM backbone): a slot's "cache" is O(1) recurrent state, so
    admission is a state scatter (``Model.insert_slots``), with no paging
    and no per-slot KV rows to size. The decode round is the contiguous
    form's. Two deltas from it:

    - a recurrent prefill cannot mask pads out of the recurrence, so
      admission groups by EXACT prompt length and the batched prefill, a
      program per (group size, length), sees no pad token and no lengths;
    - position bounds exist only where the state still carries a bounded
      cache axis (zamba2's shared-attention KV rows); a fully O(1) family
      (rwkv6, ``engine.unbounded_state``) has nothing to overflow.

    A slot that finishes mid-round runs on frozen and its state advances;
    the next admission's ``insert_slots`` overwrites it."""

    kind = "recurrent"
    spec_capable = False

    def __init__(self, engine):
        if engine.model.cache_kind != "state":
            raise ValueError(f"{engine.cfg.arch_id}: the recurrent adapter serves "
                             "cache_kind='state' families only")
        # no supports_lengths gate: exact-length groups need no lengths
        self.engine = engine

    def validate(self, requests, budget, slack=0):
        engine = self.engine
        if engine.unbounded_state:
            return
        for r in requests:
            need = len(r.tokens) + budget(r) + slack
            if need > engine.cache_len:
                raise ValueError(
                    f"request {r.id}: len={len(r.tokens)} + max_new={budget(r)} needs {need} "
                    f"cache slots but cache_len={engine.cache_len}")

    def group_len(self, n):
        # exact length: no pad token may enter the recurrence
        return n

    def prefill_insert(self, params, toks, lens, group, length):
        del lens   # exact-length groups: every row is its length
        st, model, sample = self._state(), self.engine.model, self.core.sample
        cache_len, bg, dev = self.engine.cache_len, len(group), self.engine.device

        def prefill(tokens, slots, cache, gumbel=None):
            logits, rows = model.prefill(params, {"tokens": tokens}, cache_len)
            model.insert_slots(cache, rows, slots)
            return sample(logits, gumbel=gumbel)

        prog = self.engine.graphs.program(
            "recurrent.prefill", self._key + (bg, length), prefill, lambda: {
                "tokens": torch.zeros((bg, length), dtype=torch.long, device=dev),
                "slots": torch.arange(bg, device=dev), "cache": st["cache"],
                **(noise_buffer(self.engine, bg) if GUMBEL in st else {})})
        prog.load(tokens=toks, slots=np.asarray([s for s, _ in group]))
        draw_noise(prog.inputs, self.core.gen)
        return prog.run()

    def check_positions(self, pos, live):
        if not self.engine.unbounded_state:
            ContiguousAdapter.check_positions(self, pos, live)

    def san_state(self):
        # declared in this class's own body, as the reference's adapter
        # contract asks of every concrete adapter: no pool, no table
        return {"pool": None, "table": None}


# ---------------------------------------------------------------------------
# the scheduling core
# ---------------------------------------------------------------------------

class SchedulerCore:
    """The one serving loop: admission -> grouped prefill -> decode rounds ->
    finish -> finalize, over any ``CacheAdapter``.

    Responses always contain exactly the request's budget of tokens;
    sequences that hit EOS early are padded with EOS (``make_response``).
    Host transfers: one per admission wave and one per decode or verify
    round; the host's tok/pos/live are copied into the adapter's static
    buffers. ``spec_k`` (>= 2) makes every round a speculative verify step
    with ``drafter`` (default: the n-gram drafter); ``last_spec_stats``
    reports the last serve's verify steps, delivered tokens and drafts.
    ``sanitize`` arms repro-san (``sanitizer``); None takes the engine's
    setting, so every scheduler over a sanitized engine is sanitized."""

    def __init__(self, engine, adapter: CacheAdapter, *, slots: int = 4, chunk: int = 4,
                 sampler: str = "greedy", sampler_kw=None, spec_k: int | None = None,
                 drafter=None, sanitize: bool | None = None):
        if spec_k is not None:
            if spec_k < 2:
                raise ValueError(f"spec_k must be >= 2, got {spec_k}")
            if not adapter.spec_capable or not engine.model.supports_spec:
                raise ValueError(
                    f"{engine.cfg.arch_id}: model family has no speculative "
                    "verify path (GQA decoder_lm families only)")
        self.engine = engine
        self.adapter = adapter
        self.slots = slots
        self.chunk = chunk
        self.spec_k = spec_k
        self.sampler = (sampler, sampler_sig(sampler_kw))      # keys the programs
        self.sample = make_sampler(sampler, **dict(sampler_kw or {}))
        self.drafter = (drafter if drafter is not None else NgramDrafter()) if spec_k else None
        self.gen: torch.Generator | None = None   # the serve's noise generator
        self.rounds = 0                # decode (or verify) rounds of the last serve
        self.decode_steps = 0          # decode (or verify) forward passes of the last serve
        self.last_spec_stats: dict[str, int] | None = None
        san_on = engine.sanitize if sanitize is None else bool(sanitize)
        self.sanitizer = Sanitizer(self) if san_on else None
        adapter.bind(self)

    @torch.inference_mode()
    def serve(self, requests: Sequence[Request], max_new_tokens: int, *,
              seed: int = 0) -> list[Response]:
        """Serve ``requests``; a noise-drawing sampler draws from a generator
        on the engine's device seeded with ``seed``. While spans are recorded
        (``serving/spans.py``) the call is a ``serve`` span, closed also when
        it raises."""
        if not spans.ON:
            return self._serve(requests, max_new_tokens, seed, None)
        sp = spans.begin("serve", requests=len(requests), slots=self.slots)
        try:
            return self._serve(requests, max_new_tokens, seed, sp)
        finally:
            spans.end(sp)

    def _serve(self, requests: Sequence[Request], max_new_tokens: int, seed: int,
               sp: int | None) -> list[Response]:
        """The loop; ``sp`` is the ``serve`` span (None: spans are off), the
        parent of the ``request`` spans."""
        engine, adapter, B = self.engine, self.adapter, self.slots
        eos = engine.eos_id
        rec = sp is not None
        if rec:
            arrival = time.perf_counter_ns()        # every request arrives at the call
            admit_ns, first_ns = [0] * B, [0] * B

        def budget(r: Request) -> int:
            return r.max_new if r.max_new is not None else max_new_tokens

        # a verify chunk touches cache columns up to pos + spec_k - 1: spec_k
        # slots of slack past the vanilla need (frozen slots' chunks index too)
        adapter.validate(requests, budget, self.spec_k or 0)
        adapter.begin_serve()
        san = self.sanitizer
        if san is not None:
            san.begin_serve(adapter, adapter.cache())
        self.gen = torch.Generator(device=engine.device).manual_seed(seed)
        pending = deque(requests)
        slot_req: list[Request | None] = [None] * B
        slot_toks: list[list[int]] = [[] for _ in range(B)]
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        live = np.zeros((B,), bool)
        remaining = np.zeros((B,), np.int64)
        out: dict[int, Response] = {}
        self.rounds = self.decode_steps = 0
        self.last_spec_stats = stats = (
            {"verify_steps": 0, "generated": 0, "drafted": 0, "accepted": 0}
            if self.spec_k is not None else None)

        def finish(s: int):
            r = slot_req[s]
            out[r.id] = make_response(r, slot_toks[s], budget(r), eos)
            slot_req[s], slot_toks[s] = None, []
            remaining[s] = 0
            live[s] = False                # token and position stay frozen
            adapter.on_finish(s)
            if san is not None:
                # freeze the slot shadow, audit the request's blocks, and
                # poison its frees now, before any re-allocation can write
                san.on_request_finish(s, r.id, pos[s])
            if rec:
                spans.add("request", arrival, time.perf_counter_ns(), sp, id=r.id,
                          admit_ns=admit_ns[s], first_token_ns=first_ns[s],
                          tokens=out[r.id].length)

        while pending or live.any():
            # admission: pop pending in arrival order while a slot (and, for
            # gated adapters, worst-case capacity) is free; one batched
            # prefill per distinct group length, one scatter-insert per group
            ad = spans.begin("admit") if rec else None
            free_slots = [s for s in range(B) if slot_req[s] is None]
            admitted: dict[int, list[tuple[int, Request]]] = defaultdict(list)
            while free_slots and pending:
                r = pending[0]
                if not adapter.can_admit(r, budget(r)):
                    break                  # backpressure: decode frees space
                pending.popleft()
                s = free_slots.pop(0)
                slot_req[s], slot_toks[s] = r, []
                live[s] = True
                if san is not None:
                    san.on_admit(s, r)
                adapter.on_admit(s, r, budget(r))
                admitted[adapter.group_len(len(r.tokens))].append((s, r))
            padded = [(length, group, *pad_bucket([r for _, r in group], length))
                      for length, group in admitted.items()]
            if ad is not None:
                t_admit = spans.end(ad, admitted=sum(len(g) for g in admitted.values()))
                for group in admitted.values():
                    for s, _ in group:
                        admit_ns[s] = t_admit
            staged = []
            for length, group, toks_np, lens_np in padded:
                if san is not None:
                    san.on_prefill_group(group, length)
                pf = spans.begin("prefill", rows=len(group), length=length) if rec else None
                staged.append((group, adapter.prefill_insert(engine.params, toks_np, lens_np,
                                                             group, length)))
                if pf is not None:
                    spans.end(pf)
            if staged:
                # ONE host transfer for the whole admission wave
                rb = spans.begin("prefill.readback") if rec else None
                first = torch.cat([t for _, t in staged]).tolist()
                if rb is not None:
                    t_first = spans.end(rb)
                k = 0
                for group, _ in staged:
                    for s, r in group:
                        t = first[k]
                        k += 1
                        slot_toks[s] = [t]
                        tok[s], pos[s] = t, len(r.tokens)
                        remaining[s] = budget(r) - 1
                        if rec:
                            first_ns[s] = t_first
                        if stats is not None:
                            stats["generated"] += 1    # the prefill token is delivered too
                        if budget(r) <= 1 or (eos is not None and t == eos):
                            finish(s)

            if not live.any():
                if pending:
                    continue
                break

            pr = spans.begin("round.prepare", live=int(live.sum())) if rec else None
            adapter.before_round(pos, live)
            adapter.check_positions(pos, live)
            if san is not None:
                san.pre_round()
            self.rounds += 1
            if self.spec_k is not None:
                # speculative round: draft on the host from each slot's token
                # history, verify the chunk in one forward pass, keep the
                # accepted prefix (1..spec_k tokens a weight stream)
                K = self.spec_k
                chunk_np = draft_chunk(self.drafter, tok, live,
                                       lambda s: slot_req[s].tokens + slot_toks[s], K)
                if pr is not None:
                    spans.end(pr)
                rp = spans.begin("round.replay", steps=1) if rec else None
                out_d = adapter.verify_round(engine.params, chunk_np, pos, live, remaining)
                if rp is not None:
                    spans.end(rp)
                # ONE host transfer per round: the chunk's tokens and counts;
                # positions advance here by the commit counts, as on the device
                rb = spans.begin("round.readback") if rec else None
                host = out_d.cpu().numpy()
                if rb is not None:
                    spans.end(rb)
                cm = spans.begin("round.commit") if rec else None
                finished = len(out)
                n_out = host[:, K]
                self.decode_steps += 1
                stats["verify_steps"] += 1
                pos = np.where(live, pos + np.minimum(n_out, np.maximum(remaining, 0)), pos)
                for s in np.flatnonzero(live):
                    slot_toks[s].extend(take_accepted(host[s, :K], n_out[s], remaining[s],
                                                      eos, stats, K))
                    tok[s] = slot_toks[s][-1]
                    n = budget(slot_req[s])
                    remaining[s] = n - len(slot_toks[s])
                    if len(slot_toks[s]) >= n or (eos is not None and eos in slot_toks[s][:n]):
                        finish(s)
                if cm is not None:
                    spans.end(cm, finished=len(out) - finished)
                if san is not None:
                    san.check_round(pos, live)
                continue
            want = adapter.round_steps(live, remaining)
            if pr is not None:
                spans.end(pr)
            rp = spans.begin("round.replay") if rec else None
            toks_d, n_d = adapter.decode_round(engine.params, tok, pos, live, want)
            if rp is not None:
                spans.end(rp)
            # ONE host transfer per round: the step count and the round's
            # tokens; positions advance here by the step count, as they did
            # on the device
            rb = spans.begin("round.readback") if rec else None
            host = torch.cat([n_d.expand(1, B), toks_d]).cpu().numpy()
            if rb is not None:
                spans.end(rb)
            cm = spans.begin("round.commit") if rec else None
            finished = len(out)
            steps = int(host[0, 0])
            toks_np = host[1:1 + steps]                             # (steps, B)
            self.decode_steps += steps
            pos = np.where(live, pos + steps, pos)
            for s in range(B):
                if not live[s]:
                    continue
                n = budget(slot_req[s])
                slot_toks[s].extend(int(t) for t in toks_np[:, s])
                tok[s] = slot_toks[s][-1]
                remaining[s] = n - len(slot_toks[s])
                done = len(slot_toks[s]) >= n
                if eos is not None and eos in slot_toks[s][:n]:
                    done = True
                if done:
                    finish(s)
            if cm is not None:
                spans.note(rp, steps=steps)          # the steps the round counted
                spans.end(cm, finished=len(out) - finished)
            if san is not None:
                san.check_round(pos, live)

        if san is not None:
            san.finalize()
        adapter.end_serve()
        return [out[r.id] for r in requests]
