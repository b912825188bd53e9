"""repro-san: the opt-in cache-memory and numerics sanitizer (the port's
counterpart of ``repro/analysis/sanitizer.py``).

``BlockPool`` recycles KV blocks without zeroing, the paged kernel
(``csrc/paged_attn.cu``) reads the pool through the block table, and the
captured programs (``serving/graphs.py``) hold the pool by address. A
use-after-free or a leaked block therefore returns stale but plausible K/V
and changes tokens without a crash. repro-san turns those silent faults
into immediate, attributed errors:

- **Shadow state** (analysis/shadow.py): every ``BlockPool`` alloc/free and
  every adapter admit/finish/snapshot is mirrored on the host. Double
  reserve, double free, leaks at request finish and at the end of a serve,
  writes to frozen slots, pad rows entering a recurrence and snapshots of
  dead slots raise :class:`~repro_torch.analysis.shadow.SanitizerError` at
  the faulty call, with block, slot and request.
- **Poison on free**: freed blocks are filled with
  :data:`~repro_torch.analysis.shadow.POISON` (finite: shadow.py says why
  the tokens stay the same) in place, in the pool's own storage, which the
  replayed programs read by address; ``kernels/ref.paged_poison_counts``
  finds any committed position of a slot that still reaches a freed block.
- **Numerics tripwires**: the ``core/quant.py`` boundary checks are armed
  (a bad weight raises with its param and layer class, core/policy.py),
  each round counts NaN/Inf/overflow per cache leaf per layer, and the
  engine checks its final logits.

Cost: the per-round tripwires are torch ops on the engine's device, run
between replays (never inside a captured graph), brought to the host with
one ``.cpu()`` a round, so the host-sync budget of the scheduler files
(analysis/host_sync.py) holds under sanitize. Enable with ``sanitize=True``
on ``InferenceEngine``/``SchedulerCore``, ``REPRO_SAN=1`` in the
environment, or ``--sanitize`` on the serve CLI.

Quantized KV pools (``kv_quant`` int8 or fp8) are refused in paged mode:
the reference casts ``POISON`` to the pool's storage type, which overflows
int8 (``OverflowError``) and becomes NaN in float8_e4m3fn (a false
numerics alarm); the reference has no poison pattern for them, and the port
adds none.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.analysis.shadow import (
    OVERFLOW_LIMIT,
    POISON,
    SanitizerError,
    ShadowBlockTracker,
    SlotShadow,
)
from repro_torch.core.quant import set_numerics_checks
from repro_torch.core.tree import tree_items
from repro_torch.kernels.ref import paged_poison_counts

__all__ = [
    "ENV_VAR",
    "Sanitizer",
    "check_array",
    "sanitize_enabled",
]

ENV_VAR = "REPRO_SAN"

# the pool leaves the poison fill writes and the oracle reads
POOL_LEAVES = ("k_pages", "v_pages")


def sanitize_enabled(default: bool = False) -> bool:
    """True when the environment opts into repro-san (``REPRO_SAN=1``)."""
    v = os.environ.get(ENV_VAR)
    if v is None:
        return default
    return v not in ("", "0")


def check_array(tag: str, x) -> None:
    """Host-side NaN/Inf/overflow check of a tensor or array (the engine's
    logits): one device read a ``generate`` call, not a round."""
    a = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.issubdtype(a.dtype, np.inexact):
        return
    bad = ~np.isfinite(a) | (np.abs(a) > OVERFLOW_LIMIT)
    n = int(bad.sum())
    if n:
        idx = tuple(int(i) for i in np.argwhere(bad)[0])
        raise SanitizerError(
            f"repro-san[numerics]: {tag}: {n} non-finite/overflow value(s) "
            f"of {a.size}, first at index {idx} = {a[idx]!r}")


def _leaf_name(path: str) -> str:
    """'a/b' -> "['a']['b']", the reference's ``jax.tree_util.keystr``."""
    return "".join(f"[{k!r}]" for k in path.split("/"))


def _refuse_unpoisonable(cache: dict) -> None:
    """The poison fill needs a floating pool type whose range holds ``POISON``."""
    for name in POOL_LEAVES:
        dt = cache[name].dtype
        if not dt.is_floating_point or torch.finfo(dt).max < abs(POISON):
            raise NotImplementedError(
                f"repro-san: the paged pool's {name} is stored as {dt}, which cannot hold the "
                f"poison fill {POISON!r} (the reference's Sanitizer casts it to the pool's "
                "storage type: OverflowError for int8, NaN for float8_e4m3fn, which its own "
                "numerics tripwire then reports as a false alarm); serve a float KV pool "
                "(kv_quant off) under sanitize")


def _layer_counts(leaf: torch.Tensor) -> torch.Tensor:
    """Per-axis-0 (layer) count of NaN/Inf/overflow values, int32."""
    bad = ~(leaf.float().abs() <= OVERFLOW_LIMIT)            # NaN compares False
    if bad.ndim < 2:
        return bad.sum(dtype=torch.int32).reshape(1)
    return bad.reshape(bad.shape[0], -1).sum(-1, dtype=torch.int32)


class Sanitizer:
    """Per-core sanitizer: one instance per ``SchedulerCore``, re-armed by
    ``begin_serve`` for every serve. The core calls the hooks below at the
    reference's points; adapters reach it only through ``san_state()``
    (their pool and table), the shadowed pool, and the snapshot hook.
    ``stats`` counts the last serve's checked rounds, poisoned blocks and
    poison reach, and the host seconds of its round checks (each ends in
    its device read, so they include the checks' device time)."""

    def __init__(self, core):
        self.core = core
        self.adapter = None
        self.cache: dict | None = None
        self.slots_shadow: SlotShadow | None = None
        self.tracker: ShadowBlockTracker | None = None
        self.table = None               # the adapter's host block table (shared ref)
        self._leaves: list[tuple[str, torch.Tensor]] = []
        self.stats = {"rounds_checked": 0, "blocks_poisoned": 0, "poison_reach": 0,
                      "check_s": 0.0}
        set_numerics_checks(True)       # quantize/dequantize boundary guards

    # -- serve lifecycle -----------------------------------------------------

    def begin_serve(self, adapter, cache: dict) -> None:
        """Arm for one serve over ``adapter``'s static ``cache`` (the tree
        its programs read and write in place)."""
        self.adapter = adapter
        self.cache = cache
        self.slots_shadow = SlotShadow(self.core.slots, adapter.kind)
        st = adapter.san_state()
        pool, self.table = st.get("pool"), st.get("table")
        self.tracker = None
        if pool is not None:
            _refuse_unpoisonable(cache)
            self.tracker = ShadowBlockTracker(pool.num_blocks)
            pool.shadow = self.tracker
        self._leaves = [(_leaf_name(p), leaf) for p, leaf in tree_items(cache)
                        if leaf.is_floating_point()]
        self.stats = {"rounds_checked": 0, "blocks_poisoned": 0, "poison_reach": 0,
                      "check_s": 0.0}

    def on_admit(self, s: int, r) -> None:
        self.slots_shadow.on_admit(s, r.id)
        if self.tracker is not None:
            self.tracker.set_context(s)   # the admission's prompt-block alloc

    def on_prefill_group(self, group, length: int) -> None:
        self.slots_shadow.check_prefill_group(
            [s for s, _ in group], [len(r.tokens) for _, r in group], length)

    def on_request_finish(self, s: int, req_id, pos_s) -> None:
        """After ``adapter.on_finish(s)``: freeze the slot, audit that every
        block it owned came back, and poison the frees now: a deferred fill
        would race a re-allocation of the same block and clobber its
        prefill's writes."""
        self.slots_shadow.on_finish(s, pos_s)
        if self.tracker is not None:
            self.tracker.audit_request(s, req_id)
            self._apply_poison()

    def pre_round(self) -> None:
        """Poison what out-of-band frees left pending (anything that called
        ``pool.free`` outside the finish path) before the round reads the
        pool."""
        if self.tracker is not None and self.tracker.pending_poison:
            self._apply_poison()

    def check_round(self, pos, live) -> None:
        """The per-round tripwires: frozen-slot drift on the host, then every
        per-leaf per-layer count and the poison reach as device ops, brought
        to the host with one read."""
        del live
        t0 = time.perf_counter()
        self.slots_shadow.check_frozen(pos)
        parts = [_layer_counts(leaf) for _, leaf in self._leaves]
        paged = self.tracker is not None
        if paged:
            pc = paged_poison_counts(self.cache["k_pages"], self.cache["v_pages"],
                                     torch.from_numpy(np.asarray(self.table)),
                                     torch.from_numpy(np.asarray(pos)), POISON)
            parts.append(pc.reshape(-1))
        host = torch.cat(parts).cpu().numpy() if parts else None   # the one device read a round
        self.stats["rounds_checked"] += 1
        self.stats["check_s"] += time.perf_counter() - t0
        off = 0
        for (name, _), c in zip(self._leaves, parts):
            counts = host[off:off + c.numel()]
            off += c.numel()
            total = int(counts.sum())
            if total:
                layers = np.flatnonzero(counts).tolist()
                raise SanitizerError(
                    "repro-san[numerics]: non-finite/overflow values in "
                    f"cache leaf {name}: {total} value(s) at axis-0 (layer) "
                    f"indices {layers} (per-layer counts "
                    f"{counts[layers].tolist()})")
        if paged:
            pc = host[off:].reshape(tuple(pc.shape))
            self.stats["poison_reach"] += int(pc.sum())
            if pc.sum():
                ell, s, j = (int(i) for i in np.argwhere(pc)[0])
                phys = int(self.table[s, j])
                gen = self.tracker.generation[phys]
                raise SanitizerError(
                    "repro-san[paged]: poison read — use-after-free: layer "
                    f"{ell}, slot {s} (request {self.slots_shadow.req[s]}) "
                    f"still maps freed physical block {phys} (generation "
                    f"{gen}) at virtual block {j}; "
                    f"{int(pc[ell, s, j])} committed position(s) reach it")

    def on_snapshot(self, slots) -> None:
        """Adapter snapshot hook: snapshotting a dead slot is a
        use-after-free on the snapshot path; a table row that disagrees with
        the shadow's ownership would carry phantom or aliased blocks."""
        if self.slots_shadow is None:
            return
        slot_ids = [int(s) for s in np.asarray(slots).reshape(-1)]
        self.slots_shadow.check_snapshot(slot_ids)
        if self.tracker is not None:
            for s in slot_ids:
                shadow = self.tracker.slot_blocks(s)
                mapped = sorted(int(b) for b in self.table[s] if b != 0)
                if mapped != shadow:
                    raise SanitizerError(
                        f"repro-san[paged]: snapshot of slot {s} carries "
                        f"phantom/aliased blocks: table maps {mapped} but "
                        f"shadow ownership is {shadow}")

    def finalize(self) -> None:
        """End-of-serve audit: nothing owned, nothing live, and shadow and
        pool agree that the pool drained back to empty."""
        if self.tracker is not None:
            self.tracker.audit_final()
            pool = self.adapter.san_state().get("pool")
            if pool is not None and pool.live_blocks != 0:
                raise SanitizerError(
                    f"repro-san[paged]: pool reports {pool.live_blocks} live "
                    "block(s) at end of serve but the shadow saw every block "
                    "freed — an allocation bypassed the shadowed pool")
        leftover = self.slots_shadow.live_slots()
        if leftover:
            raise SanitizerError(
                f"repro-san[{self.slots_shadow.kind}]: slot(s) {leftover} "
                "still live at end of serve — requests finished without "
                "on_finish")

    # -- device work ---------------------------------------------------------

    def _apply_poison(self) -> None:
        """Fill the drained blocks with ``POISON`` in the pool's own storage
        (the replayed programs hold it by address: a new tensor would leave
        them reading the unpoisoned pool)."""
        blocks = self.tracker.drain_poison()
        if not blocks:
            return
        pages = self.cache["k_pages"]
        idx = torch.tensor(sorted(set(blocks)), dtype=torch.long).to(pages.device)
        for name in POOL_LEAVES:
            self.cache[name].index_fill_(1, idx, POISON)
        self.stats["blocks_poisoned"] += len(idx)
