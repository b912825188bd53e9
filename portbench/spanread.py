"""Reductions of the program's own spans (``repro_torch.serving.spans``):
round gaps, decode replays, inter-token times, the prefill stretch, host time
by span, and a traced call's device trace read against the spans (idle gaps
labelled by program span, ``idle_by_span``, short gaps, ``commit_overlap``).
The span readers under ``portbench/metrics/`` and ``spanrun.py`` use them.

A span list is what ``spans.record()`` yields: ``Span(name, start_ns,
end_ns, parent, attrs)``, ``perf_counter`` nanoseconds, ``parent`` an index
into the list. ``request`` spans overlap one another and are left out where
the spans are read as a tree (the innermost span at an instant).
"""

from __future__ import annotations

import bisect
import statistics

OUTSIDE = "outside program spans"
SHORT_NS = 10_000                   # an idle gap "under 10 us"
DEVICE_WORK = ("round.replay", "prefill")



def named(recs, name: str) -> list:
    return [s for s in recs if s.name == name]


def round_gaps_ns(recs) -> list[int]:
    """For each decode round that another span of its call launching device work
    follows: host ns from its ``round.readback`` returning to the start of
    the next ``round.replay`` or ``prefill`` of the same call."""
    out, last = [], {}
    for s in recs:
        if s.name == "round.readback":
            last[s.parent] = s.end_ns
        elif s.name in DEVICE_WORK and s.parent in last:
            out.append(s.start_ns - last.pop(s.parent))
    return out


def decode_replays_ns(recs) -> list[int]:
    """Host ns of each ``program.replay`` inside a ``round.replay``: the
    decode (or verify) program's replays."""
    return [s.end_ns - s.start_ns for s in named(recs, "program.replay")
            if s.parent >= 0 and recs[s.parent].name == "round.replay"]


def replay_stats(recs) -> dict | None:
    """Host us of the decode program's replays: their median and longest,
    and the median of each round's first (the one the card waits for)."""
    ns = decode_replays_ns(recs)
    if not ns:
        return None
    first, seen = [], set()
    for s in named(recs, "program.replay"):
        if s.parent >= 0 and recs[s.parent].name == "round.replay" and s.parent not in seen:
            seen.add(s.parent)
            first.append(s.end_ns - s.start_ns)
    return {"count": len(ns), "p50": statistics.median(ns) / 1e3, "max": max(ns) / 1e3,
            "first_of_round_p50": statistics.median(first) / 1e3}


def inter_token_ms(recs) -> list[float]:
    """Each request of two or more tokens: (finish - first token) / (tokens - 1)."""
    return [(s.end_ns - s.attrs["first_token_ns"]) / 1e6 / (s.attrs["tokens"] - 1)
            for s in named(recs, "request") if s.attrs["tokens"] > 1]


def prefill_stretch_ns(recs) -> dict[int, int]:
    """Per ``serve`` span (its index): ns from its first ``prefill`` starting
    to the first ``prefill.readback`` after it returning."""
    start, out = {}, {}
    for s in recs:
        if s.name == "prefill" and s.parent not in start:
            start[s.parent] = s.start_ns
        elif s.name == "prefill.readback" and s.parent in start and s.parent not in out:
            out[s.parent] = s.end_ns - start[s.parent]
    return out


def serve_host_ns(recs) -> list[int]:
    """Each ``serve`` span with a prefill less its prefill stretch."""
    pre = prefill_stretch_ns(recs)
    return [recs[i].end_ns - recs[i].start_ns - ns for i, ns in pre.items()]


def exclusive(recs) -> list[tuple[int, int, str]]:
    """(start, end, name) of the stretches where each span is the innermost
    one open, sorted; ``request`` spans left out."""
    tree = [(i, s) for i, s in enumerate(recs) if s.name != "request"]
    kids: dict[int, list] = {}
    for i, s in tree:
        kids.setdefault(s.parent, []).append(s)
    out = []
    for i, s in tree:
        t = s.start_ns
        for c in sorted(kids.get(i, ()), key=lambda c: c.start_ns):
            if c.start_ns > t:
                out.append((t, c.start_ns, s.name))
            t = max(t, c.end_ns)
        if s.end_ns > t:
            out.append((t, s.end_ns, s.name))
    return sorted(out)


def host_ms_by_span(recs) -> dict[str, float]:
    """Host ms in which each span name was the innermost open."""
    out: dict[str, float] = {}
    for a, b, name in exclusive(recs):
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_by_span(gaps, recs) -> dict[str, float]:
    """Idle seconds of ``gaps`` ((start, end) perf_counter ns, sorted and
    disjoint) divided among the innermost program spans open in them; the
    rest under ``OUTSIDE``."""
    ex = exclusive(recs)
    out: dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(ex) and ex[j][1] <= g0:
            j += 1
        inside, k = 0, j
        while k < len(ex) and ex[k][0] < g1:
            a, b, name = ex[k]
            ns = min(b, g1) - max(a, g0)
            out[name] = out.get(name, 0.0) + ns / 1e9
            inside += ns
            k += 1
        out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - inside) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def gap_label(g0: int, g1: int, recs, fallback: str) -> str:
    """The innermost program span that covers most of the gap: from the
    call's span down, into the child that covers more than half of it;
    ``fallback`` where no program span covers most of it."""
    kids: dict[int, list] = {}
    for i, s in enumerate(recs):
        if s.name != "request":
            kids.setdefault(s.parent, []).append(i)

    def cover(i):
        return min(recs[i].end_ns, g1) - max(recs[i].start_ns, g0)

    label, node = fallback, -1
    while True:
        best = max(kids.get(node, ()), default=None, key=cover)
        if best is None or 2 * cover(best) <= g1 - g0:
            return label
        label, node = recs[best].name, best


def commit_overlap(events_ns, recs) -> int:
    """Device events (start, end perf_counter ns) that start inside a
    ``round.commit`` span."""
    commits = sorted((s.start_ns, s.end_ns) for s in named(recs, "round.commit"))
    starts = [a for a, _ in commits]
    n = 0
    for e0, _ in events_ns:
        i = bisect.bisect_right(starts, e0) - 1
        n += i >= 0 and e0 < commits[i][1]
    return n


def slice_view(sl, recs, fallback: str) -> dict | None:
    """A traced call's device trace read against the program's spans: its
    idle gaps on the ``perf_counter`` clock (as ``trace.reduce`` finds them),
    the longest ten labelled, ``idle_by_span``, the gaps under 10 us and
    ``commit_overlap``."""
    from portbench import trace as tr

    if not sl.events:
        return None
    clock = tr._clock(sl.events, sl.host)
    if clock is None:
        return None
    a, b = sl.host[clock]
    shift = sl.host["perf_counter"][0] - a
    ev = [(max(s, a) + shift, min(e, b) + shift) for _, s, e in sl.events if e > a and s < b]
    busy = tr.union(ev)
    gaps, prev = [], a + shift
    for s, e in busy + [(b + shift, b + shift)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    short = [g for g in gaps if g[1] - g[0] < SHORT_NS]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"idle_s": sum(e - s for s, e in gaps) / 1e9,
            "idle_gaps": [[gap_label(g0, g1, recs, fallback), (g1 - g0) / 1e9]
                          for g0, g1 in longest],
            "idle_by_span": idle_by_span(gaps, recs),
            "short_gaps": {"count": len(short), "s": sum(e - s for s, e in short) / 1e9},
            "commit_overlap": commit_overlap(ev, recs)}


def decode_view(whole: dict, part: dict) -> dict:
    """``whole`` less ``part`` (the same requests' prefill alone): the decode
    steps' idle, by span, and the share of it inside program spans."""
    keys = set(whole["idle_by_span"]) | set(part["idle_by_span"])
    by = {k: whole["idle_by_span"].get(k, 0.0) - part["idle_by_span"].get(k, 0.0) for k in keys}
    idle = whole["idle_s"] - part["idle_s"]
    return {"idle_s": idle, "idle_by_span": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "inside_pct": 100.0 * (1 - by.get(OUTSIDE, 0.0) / idle) if idle > 0 else None,
            "short_gaps": {k: whole["short_gaps"][k] - part["short_gaps"][k]
                           for k in ("count", "s")}}
