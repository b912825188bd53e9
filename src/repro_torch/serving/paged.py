"""Paged KV-cache serving: block-pool allocator and the paged cache adapter
(counterpart of ``repro/serving/paged.py``).

The cache is a pool of fixed-size KV blocks instead of one ``cache_len``
row per slot:

- ``BlockPool``: host-side allocator over ``num_blocks`` blocks of
  ``block_size`` token slots. Block 0 is the reserved write-off sink:
  unallocated block-table entries point at it, so stray writes (the prompt
  pad tail, frozen slots) land somewhere harmless. Blocks are recycled
  without zeroing: paged attention substitutes the current column's score
  and value and masks everything past ``pos``, so stale rows are never
  reached.
- ``PagedAdapter``: the block pool behind the scheduling core's loop
  (serving/core.py). Requests admit into fixed decode slots (one batched
  prefill per bucket, scattered into their blocks), blocks are allocated on
  demand a round ahead, and a decode round stops at the step any live slot
  finishes, so its blocks are freed and the queue re-admitted at that step.
- ``PagedScheduler``: the front that picks the adapter and reports the
  residency high-water mark.

Under repro-san (analysis/sanitizer.py) the pool's ``shadow`` mirrors
every alloc and free, freed blocks are filled with the poison value in the
pool's own storage, and ``PagedAdapter.snapshot`` checks the slots against
the shadow.

Admission is reservation-gated (``can_admit``): a request is admitted only
when the pool covers every live request's worst-case remaining need plus
its own, so allocation for live slots never fails and no preemption path is
needed.

Where the reference runs a device ``while_loop`` that exits at the first
finish, a round here replays its captured decode step
``min(chunk, min(remaining[live]))`` times, a count the host knows before
the round (the reference's budget exit). The EOS exit stays on the device:
the step at which a live slot emits EOS sets a ``stopped`` flag, later steps
of the round leave tokens and positions as they are (their cache writes
land at each slot's next position, which the next real step rewrites
before it attends), and the round's step count ``n`` crosses to the host
with its tokens, in the round's one transfer.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import flags
from repro_torch.serving.core import (
    CacheAdapter,
    Request,
    Response,
    SchedulerCore,
    bucket_length,
    noise_buffer,
    replay_round,
    replay_verify,
    round_state,
    verify_inputs,
)
from repro_torch.serving.sampling import GUMBEL, draw_noise, needs_noise, sampler_sig
from repro_torch.serving.spec import build_verify_step

__all__ = ["BlockPool", "PagedAdapter", "PagedScheduler", "paged_scheduler", "serve_paged"]


class BlockPool:
    """Fixed-size KV block allocator. Block ids index the device pool's block
    axis; block 0 is the reserved sink and is never handed out. Freed
    blocks are reused last-in first-out. Tracks ``peak_live``, the
    high-water mark of allocated blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks (block 0 is the sink)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))   # LIFO reuse
        self._free_set = set(self._free)
        self.peak_live = 0
        # repro-san hook (analysis/shadow.py ShadowBlockTracker): when set,
        # every alloc and free is mirrored (ownership, generations, poison)
        self.shadow = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"block pool exhausted: want {n}, free {len(self._free)} "
                               f"of {self.num_blocks - 1}")
        out = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        self.peak_live = max(self.peak_live, self.live_blocks)
        if self.shadow is not None:
            self.shadow.on_alloc(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        if self.shadow is not None:
            # first: the shadow's diagnosis (double free with its generation)
            # says more than the bare ValueError below
            self.shadow.on_free(blocks)
        for b in blocks:
            # a double free would hand one physical block to two requests
            if not 0 < b < self.num_blocks or b in self._free_set:
                raise ValueError(f"bad free of block {b}: out of range, "
                                 "double-freed, or the sink")
            self._free.append(b)
            self._free_set.add(b)


class PagedAdapter(CacheAdapter):
    """Block-pool cache behind the scheduling core: per-slot block tables
    over a ``BlockPool``, reservation-gated admission, on-demand block
    growth before each round, blocks reclaimed the step a slot finishes."""

    kind = "paged"
    spec_capable = True

    def __init__(self, engine, *, block_size: int = 8, num_blocks: int | None = None,
                 max_len: int | None = None):
        if not engine.model.supports_paged:
            raise ValueError(
                f"{engine.cfg.arch_id}: paged serving needs a block-pool cache "
                "(GQA decoder_lm families)")
        self.engine = engine
        self.block_size = block_size
        self.max_len = max_len if max_len is not None else engine.cache_len
        self.blocks_per_req = math.ceil(self.max_len / block_size)
        self._num_blocks_arg = num_blocks
        self.num_blocks: int | None = None   # resolved at bind (needs slots)
        self.pool: BlockPool | None = None   # per-serve allocator

    def bind(self, core):
        self.core = core
        # the default pool matches the contiguous footprint (every slot's
        # worst case); smaller pools exercise backpressure
        self.num_blocks = (self._num_blocks_arg if self._num_blocks_arg is not None
                           else core.slots * self.blocks_per_req + 1)
        # block lookahead per round: a verify chunk commits up to spec_k rows
        # a slot in one step
        self._ahead = core.chunk if core.spec_k is None else max(core.chunk, core.spec_k)
        self._key = (core.slots, core.chunk, self.num_blocks, self.block_size,
                     self.blocks_per_req, core.sampler)
        if core.spec_k is not None:
            self._verify_step = build_verify_step(
                self.engine.model, self.engine.params, sampler=core.sampler[0],
                sampler_kw=dict(core.sampler[1]), paged=True)

    # -- sizing helpers -----------------------------------------------------

    def _prompt_pad(self, n: int) -> int:
        """Padded prefill length: the power-of-two bucket, rounded up to a
        whole number of blocks."""
        return math.ceil(bucket_length(n) / self.block_size) * self.block_size

    def _blocks_needed(self, r: Request, budget: int) -> int:
        # decode commits positions len .. len+budget-2 (the first generated
        # token comes from prefill); the prompt occupies 0 .. len-1
        last = len(r.tokens) + max(budget - 1, 0)
        return math.ceil(max(last, 1) / self.block_size)

    def _reserved_backlog(self) -> int:
        """Blocks the live slots may still demand beyond what they hold."""
        return sum(self._slot_need[s] - len(self._slot_blocks[s])
                   for s in range(len(self._slot_need)) if self._slot_live[s])

    def _ensure_blocks(self, s: int, p: int) -> None:
        """Grow slot ``s`` to cover the next round's commits; reservation-
        gated admission guarantees this never fails."""
        bs = self.block_size
        target = min(math.ceil((p + self._ahead) / bs), self._slot_need[s])
        delta = target - len(self._slot_blocks[s])
        if delta > 0:
            if self.pool.shadow is not None:
                self.pool.shadow.set_context(s)   # attribute the growth alloc
            new = self.pool.alloc(delta)
            start = len(self._slot_blocks[s])
            self._slot_blocks[s].extend(new)
            self.table[s, start:start + len(new)] = new

    # -- CacheAdapter surface ------------------------------------------------

    def validate(self, requests, budget, slack=0):
        if flags.get("kvt_cache_layout") or flags.get("int8_kv_cache"):
            raise ValueError("paged serving supports the base float KV layout "
                             "(kvt_cache_layout / int8_kv_cache flags off)")
        mb, bs = self.blocks_per_req, self.block_size
        for r in requests:
            need = max(self._prompt_pad(len(r.tokens)), len(r.tokens) + budget(r) + slack)
            if need > mb * bs:
                raise ValueError(
                    f"request {r.id}: len={len(r.tokens)} + max_new={budget(r)}"
                    + (f" + spec_k={slack}" if slack else "")
                    + f" needs {need} cache slots but the paged table covers "
                    f"{mb} blocks x {bs} = {mb * bs}")
            if self._blocks_needed(r, budget(r)) > self.num_blocks - 1:
                raise ValueError(
                    f"request {r.id}: needs {self._blocks_needed(r, budget(r))} "
                    f"blocks but the pool has {self.num_blocks - 1}")

    def _state(self) -> dict:
        """The static pool, block table and round buffers (they outlive a
        serve)."""
        engine, slots = self.engine, self.core.slots

        def make():
            st = round_state(engine, slots, self.core.chunk, engine.model.init_paged_cache(
                self.num_blocks, self.block_size, engine.cfg.cdtype(), engine.device),
                needs_noise(self.core.sampler[0]))
            st["table"] = torch.zeros((slots, self.blocks_per_req), dtype=torch.int32,
                                      device=engine.device)
            return st

        return engine.graphs.state("paged", self._key, make)

    def begin_serve(self):
        B, bs = self.core.slots, self.block_size
        self.pool = BlockPool(self.num_blocks, bs)
        self.table = np.zeros((B, self.blocks_per_req), np.int32)   # 0 = sink
        self._slot_blocks: list[list[int]] = [[] for _ in range(B)]
        self._slot_need = [0] * B              # worst-case total blocks
        self._slot_live = np.zeros((B,), bool)
        for leaf in self._state()["cache"].values():
            leaf.zero_()

    def can_admit(self, r, budget):
        # reservation-gated: admit only when the pool covers every live
        # slot's worst-case remaining growth plus this request's whole need
        return (self._blocks_needed(r, budget)
                <= self.pool.free_blocks - self._reserved_backlog())

    def on_admit(self, s, r, budget):
        prompt_blocks = self.pool.alloc(math.ceil(len(r.tokens) / self.block_size))
        self._slot_blocks[s] = prompt_blocks
        self._slot_need[s] = self._blocks_needed(r, budget)
        self.table[s, :] = 0
        self.table[s, : len(prompt_blocks)] = prompt_blocks
        self._slot_live[s] = True

    def group_len(self, n):
        return self._prompt_pad(n)

    def prefill_insert(self, params, toks, lens, group, length):
        """Prefill to the padded prompt length (the pool is the only
        persistent cache, so no cache_len-wide row is built), then scatter
        the contiguous rows (L, bg, S, KV[, hd]) block by block into the
        slots' prompt blocks, in place: one program per (group size,
        length). Table entries past a prompt's own blocks are the sink: its
        duplicate writes are harmless."""
        st, model, sample = self._state(), self.engine.model, self.core.sample
        bs, bg, dev = self.block_size, len(group), self.engine.device

        def put(pages, r, tables):
            ell, bg = r.shape[:2]
            pages[:, tables] = r.reshape(ell, bg, tables.shape[1], bs, *r.shape[3:])

        def prefill(tokens, lengths, tables, cache, gumbel=None):
            logits, rows = model.prefill(params, {"tokens": tokens, "lengths": lengths},
                                         length)
            if "k_q" in rows:
                # quantized prefill rows arrive kvt-major (L, bg, KV, S[, hd]):
                # move time ahead of the heads so the block reshape applies
                for leaf, name in (("k_pages", "k_q"), ("k_scales", "k_s"),
                                   ("v_pages", "v_q"), ("v_scales", "v_s")):
                    put(cache[leaf], rows[name].movedim(3, 2), tables)
            else:
                put(cache["k_pages"], rows["k"], tables)
                put(cache["v_pages"], rows["v"], tables)
            return sample(logits, gumbel=gumbel)

        prog = self.engine.graphs.program(
            "paged.prefill", self._key + (bg, length), prefill, lambda: {
                "tokens": torch.zeros((bg, length), dtype=torch.long, device=dev),
                "lengths": torch.full((bg,), length, dtype=torch.long, device=dev),
                "tables": torch.zeros((bg, length // bs), dtype=torch.long, device=dev),
                "cache": st["cache"], **(noise_buffer(self.engine, bg) if GUMBEL in st else {})})
        prog.load(tokens=toks, lengths=lens,
                  tables=np.stack([self.table[s, : length // bs] for s, _ in group]))
        draw_noise(prog.inputs, self.core.gen)
        return prog.run()

    def before_round(self, pos, live):
        for s in range(len(live)):
            if live[s]:
                self._ensure_blocks(s, int(pos[s]))

    def check_positions(self, pos, live):
        mb, bs = self.blocks_per_req, self.block_size
        assert not live.any() or int(pos[live].max()) < mb * bs, (
            f"live slot position escaped the block table: {pos[live]}")

    def round_steps(self, live, remaining):
        """The reference's budget exit, known before the round: stop at the
        step the first live slot reaches its budget, at most ``chunk``."""
        return min(self.core.chunk, int(remaining[live].min()))

    def decode_round(self, params, tok, pos, live, steps):
        """``steps`` replays of the captured paged decode step; with an
        ``eos_id`` the step at which a live slot emits EOS stops the round on
        the device (see the module docstring), and ``n`` counts the steps
        up to it. The block table crosses to the device as a snapshot (a
        copy into the static table, not a view of the host array
        ``on_finish`` rewrites)."""
        st, model, sample, eos = self._state(), self.engine.model, self.core.sample, \
            self.engine.eos_id

        def step(tok, pos, live, stopped, n, table, cache, gumbel=None):
            act = live & ~stopped
            logits, _ = model.decode_paged(params, tok, cache, table, pos)
            tok.copy_(torch.where(act, sample(logits, gumbel=gumbel), tok))   # frozen: keep tok
            pos.copy_(torch.where(act, pos + 1, pos))          # ...and their position
            n.add_((~stopped).long())
            if eos is not None:
                stopped |= (act & (tok == eos)).any()

        names = ("tok", "pos", "live", "stopped", "n", "table", "cache") + (
            GUMBEL,) * (GUMBEL in st)
        prog = self.engine.graphs.program("paged.decode", self._key + (eos,), step,
                                          lambda: {k: st[k] for k in names})
        return replay_round(prog, st, tok, pos, live, steps, self.core.gen, table=self.table)

    def verify_round(self, params, chunk, pos, live, remaining):
        """One replay of the captured paged verify step over the pool, the
        block table crossing as a snapshot (as in ``decode_round``). Rejected
        rows change no pool bit, block 0 included."""
        core, st = self.core, self._state()
        prog = self.engine.graphs.program(
            "paged.verify", self._key + (core.spec_k,), self._verify_step,
            lambda: verify_inputs(self.engine, core.slots, core.spec_k, core.sampler[0],
                                  st["cache"], table=st["table"]))
        return replay_verify(prog, core.gen, chunk, pos, live, remaining, table=self.table)

    def on_finish(self, s):
        self.pool.free(self._slot_blocks[s])
        self._slot_blocks[s], self._slot_need[s] = [], 0
        self.table[s, :] = 0                   # stray writes go to the sink
        self._slot_live[s] = False

    def snapshot(self, slots):
        """The pool and each slot's block-table row, copied to the host: pool
        rows are unaddressable without the table."""
        san = self.core.sanitizer
        if san is not None:
            san.on_snapshot(slots)
        return {"cache": {k: v.to("cpu", copy=True) for k, v in self.cache().items()},
                "table": self.table[np.asarray(slots)].copy()}

    def san_state(self):
        return {"pool": self.pool, "table": self.table}


class PagedScheduler:
    """Paged continuous batching over one engine (see the module docstring).
    Greedy outputs are token-identical to the contiguous ``SlotScheduler``."""

    def __init__(self, engine, *, slots: int = 4, chunk: int = 4, block_size: int = 8,
                 num_blocks: int | None = None, max_len: int | None = None,
                 sampler: str = "greedy", sampler_kw=None, spec_k: int | None = None,
                 drafter=None):
        self.adapter = PagedAdapter(engine, block_size=block_size, num_blocks=num_blocks,
                                    max_len=max_len)
        self._core = SchedulerCore(engine, self.adapter, slots=slots, chunk=chunk,
                                   sampler=sampler, sampler_kw=sampler_kw, spec_k=spec_k,
                                   drafter=drafter)
        self.engine = engine
        self.slots = slots
        self.chunk = chunk
        self.spec_k = spec_k
        self.block_size = block_size
        self.max_len = self.adapter.max_len
        self.blocks_per_req = self.adapter.blocks_per_req
        self.num_blocks = self.adapter.num_blocks
        self.last_peak_blocks = 0          # residency high-water mark of the last serve
        self.last_rounds = 0               # decode rounds of the last serve
        self.last_decode_steps = 0         # paged decode forward passes of the last serve
        self.last_spec_stats = None        # speculative accounting of the last serve

    def serve(self, requests: Sequence[Request], max_new_tokens: int, *,
              seed: int = 0) -> list[Response]:
        out = self._core.serve(requests, max_new_tokens, seed=seed)
        self.last_rounds = self._core.rounds
        self.last_decode_steps = self._core.decode_steps
        self.last_spec_stats = self._core.last_spec_stats
        # the allocator's exact high-water mark
        self.last_peak_blocks = max(self.last_peak_blocks, self.adapter.pool.peak_live)
        return out


def paged_scheduler(engine, *, sampler: str = "greedy", sampler_kw=None, slots: int = 4,
                    chunk: int = 4, block_size: int = 8, num_blocks: int | None = None,
                    spec_k: int | None = None, drafter=None) -> PagedScheduler:
    """The engine's cached ``PagedScheduler`` for these settings, the one
    ``serve_paged`` serves through (its ``last_*`` fields report that serve)."""
    cache = getattr(engine, "_paged_schedulers", None)
    if cache is None:
        cache = engine._paged_schedulers = {}
    sig = (slots, chunk, block_size, num_blocks, sampler, sampler_sig(sampler_kw), spec_k,
           id(drafter) if drafter is not None else None)
    if sig not in cache:
        cache[sig] = PagedScheduler(engine, slots=slots, chunk=chunk, block_size=block_size,
                                    num_blocks=num_blocks, sampler=sampler,
                                    sampler_kw=sampler_kw, spec_k=spec_k, drafter=drafter)
    return cache[sig]


def serve_paged(engine, requests: Sequence[Request], max_new_tokens: int, *,
                sampler: str = "greedy", sampler_kw=None, seed: int = 0, slots: int = 4,
                chunk: int = 4, block_size: int = 8, num_blocks: int | None = None,
                spec_k: int | None = None, drafter=None) -> list[Response]:
    """Paged continuous batching through a per-engine cached scheduler."""
    sched = paged_scheduler(engine, sampler=sampler, sampler_kw=sampler_kw, slots=slots,
                            chunk=chunk, block_size=block_size, num_blocks=num_blocks,
                            spec_k=spec_k, drafter=drafter)
    sched.last_peak_blocks = 0
    return sched.serve(requests, max_new_tokens, seed=seed)
