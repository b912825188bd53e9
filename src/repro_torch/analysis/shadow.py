"""repro-san shadow state: host-side mirrors of the cache adapters' memory
(the port's numpy-only copy of ``repro/analysis/shadow.py``).

The serving stack's failure mode is silent: ``BlockPool`` recycles KV blocks
without zeroing (serving/paged.py), the paged kernel reads the pool through
the block table, and the captured programs (serving/graphs.py) hold the
pool by address. A use-after-free or a leaked block therefore feeds
stale but plausible K/V into attention and changes tokens without a
crash. This module holds the host-side half of the sanitizer
(analysis/sanitizer.py drives it and owns the device work):

- :class:`ShadowBlockTracker` mirrors one ``BlockPool``: per-block owner
  slot and a generation counter bumped on every free. Double-reserve and
  unowned-free raise at once; frees queue the block for the poison fill;
  per-request and end-of-serve audits catch leaks (blocks still owned after
  ``on_finish`` should have returned them).
- :class:`SlotShadow` mirrors per-slot liveness for every adapter kind:
  double-admit, writes to frozen or finished slots (position drift), pad
  rows entering a recurrent prefill, snapshots of non-live slots.
- :data:`POISON` is the freed-block fill value. Poisoned data that is
  reachable (a live slot's table still maps a freed block at a committed
  position) is found by ``kernels/ref.paged_poison_counts``.

Layering: this module is host-only (numpy) and imports nothing of the
serving package: serving/core.py imports the sanitizer, not the other way
around.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "OVERFLOW_LIMIT",
    "POISON",
    "SanitizerError",
    "ShadowBlockTracker",
    "SlotShadow",
]

# Poison pattern written over freed KV blocks. Deliberately FINITE:
# 0xDEADBEEF reinterpreted as float32 (~ -6.26e18) survives the cast to the
# cache dtype, sits below the overflow tripwire, and — critically — keeps a
# sanitized run bit-identical to the unsanitized one: every legitimately
# unreachable poisoned column is masked, its softmax weight underflows to
# exactly 0.0, and 0.0 * poison contributes the same -0.0 a stale recycled
# value would. NaN poison would infect the masked softmax (0 * NaN = NaN)
# and break the parity sweep.
POISON = float(np.frombuffer(np.uint32(0xDEADBEEF).tobytes(),
                             dtype=np.float32)[0])

# |x| above this at a checked boundary counts as overflow; the poison value
# itself stays well below it so freed-block fills never trip the numerics
# check.
OVERFLOW_LIMIT = 1e30


class SanitizerError(AssertionError):
    """A repro-san invariant violation, with block/slot/layer attribution."""


class ShadowBlockTracker:
    """Mirror of one ``BlockPool``: per-block owner slot + generation.

    Attached as ``pool.shadow``; the pool calls :meth:`on_alloc` /
    :meth:`on_free` from inside ``alloc``/``free`` so every allocation path
    (admission, ``_ensure_blocks`` growth, direct frees in tests) is seen.
    ``set_context`` names the slot about to allocate (the sanitizer sets it
    at admission, the adapter before on-demand growth).
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.owner: dict[int, int] = {}       # block -> owning slot
        self.generation = [0] * num_blocks    # bumped on every free
        self.pending_poison: list[int] = []
        self._slot = -1                       # current allocation context

    def set_context(self, slot: int) -> None:
        self._slot = slot

    def on_alloc(self, blocks) -> None:
        for b in blocks:
            if b in self.owner:
                raise SanitizerError(
                    f"repro-san[paged]: double-reserve of block {b} "
                    f"(generation {self.generation[b]}): owned by slot "
                    f"{self.owner[b]}, handed out again to slot {self._slot}")
            self.owner[b] = self._slot

    def on_free(self, blocks) -> None:
        for b in blocks:
            if b not in self.owner:
                raise SanitizerError(
                    f"repro-san[paged]: free of unowned block {b} "
                    f"(generation {self.generation[b] if 0 <= b < self.num_blocks else '?'}): "
                    "double-free, the sink, or a block the shadow never saw "
                    "allocated")
            del self.owner[b]
            self.generation[b] += 1
            self.pending_poison.append(b)

    def drain_poison(self) -> list[int]:
        out, self.pending_poison = self.pending_poison, []
        return out

    def slot_blocks(self, s: int) -> list[int]:
        return sorted(b for b, owner in self.owner.items() if owner == s)

    def audit_request(self, s: int, req_id) -> None:
        """After ``on_finish`` the slot must own nothing."""
        leaked = self.slot_blocks(s)
        if leaked:
            raise SanitizerError(
                f"repro-san[paged]: leak — request {req_id} finished but "
                f"slot {s} still owns block(s) {leaked}: on_finish must "
                "free everything on_admit/_ensure_blocks reserved")

    def audit_final(self) -> None:
        if self.owner:
            held = dict(sorted(self.owner.items()))
            raise SanitizerError(
                "repro-san[paged]: leak at finalize — block(s) still owned "
                f"at end of serve: {held} (block -> slot)")


class SlotShadow:
    """Per-slot liveness mirror shared by every adapter kind."""

    FREE, LIVE, FROZEN = "free", "live", "frozen"

    def __init__(self, n_slots: int, kind: str):
        self.kind = kind
        self.state = [self.FREE] * n_slots
        self.req: list = [None] * n_slots
        self.frozen_pos: list = [None] * n_slots

    def on_admit(self, s: int, req_id) -> None:
        if self.state[s] == self.LIVE:
            raise SanitizerError(
                f"repro-san[{self.kind}]: double-admit — slot {s} is still "
                f"live for request {self.req[s]} but was handed request "
                f"{req_id}")
        self.state[s] = self.LIVE
        self.req[s] = req_id
        self.frozen_pos[s] = None

    def on_finish(self, s: int, pos) -> None:
        if self.state[s] != self.LIVE:
            raise SanitizerError(
                f"repro-san[{self.kind}]: finish of non-live slot {s} "
                f"(state {self.state[s]})")
        self.state[s] = self.FROZEN
        self.frozen_pos[s] = int(pos)

    def check_frozen(self, pos) -> None:
        """Frozen slot positions must not drift: movement means some write
        path advanced a slot after its request finished (dead-slot write)."""
        for s, st in enumerate(self.state):
            if st == self.FROZEN and int(pos[s]) != self.frozen_pos[s]:
                raise SanitizerError(
                    f"repro-san[{self.kind}]: write to frozen slot {s} "
                    f"(request {self.req[s]} already finished): position "
                    f"moved {self.frozen_pos[s]} -> {int(pos[s])}")

    def check_prefill_group(self, group_slots, req_lens, length: int) -> None:
        """Recurrent prefill must see exact-length groups — a padded row
        feeds pad tokens INTO the recurrence and corrupts the slot state."""
        if self.kind != "recurrent":
            return
        for s, n in zip(group_slots, req_lens):
            if n != length:
                raise SanitizerError(
                    "repro-san[recurrent]: pad rows entering the recurrence "
                    f"— slot {s}'s prompt has {n} tokens but its admission "
                    f"group prefills at padded length {length}")

    def live_slots(self) -> list[int]:
        return [s for s, st in enumerate(self.state) if st == self.LIVE]

    def check_snapshot(self, slots) -> None:
        for s in slots:
            if self.state[s] != self.LIVE:
                raise SanitizerError(
                    f"repro-san[{self.kind}]: snapshot of non-live slot {s} "
                    f"(state {self.state[s]}) — snapshotting freed state is "
                    "a use-after-free on the snapshot path")
