"""The traced slice of a run: ``torch.profiler``'s CUDA activity over one whole
call, reduced to kernel intervals.

After the window, the pass's first ``requests`` requests, each cut to at most
``tokens`` tokens, are served once more under the profiler, on the thread
that serves them: their prefill groups and the first decode steps of the
window's own programs (the first admission of a wave is the same group of
requests, so nothing is captured anew). Where that decodes, the same
requests cut to their first token are profiled first: the same prefill
groups alone, so that ``difference`` leaves the decode steps. The mix's file
sizes the call in device events: a profile of half a million or more came
back empty, and a profiler started and stopped from a second thread while the
first launched replays came back empty or hung. No Chrome trace is written.

The reduction takes the union of the device intervals (busy seconds), the
time of the projection kernels (``gqmm_*`` / ``gqmv_*``), the kernels that
took most time, and the longest stretches with nothing on the card, each
labelled by the harness span the host was in.
"""

from __future__ import annotations

import re
import time

PROJECTION_KERNEL = re.compile(r"\bgqm[mv]_\w*kernel")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    head = name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0].strip()
    if head.startswith("void "):
        head = head[5:].strip()
    return head or name[:64]


class Slice:
    """One profiled call: its device events and the host's stretch."""

    def __init__(self):
        self.events: list[tuple[str, int, int]] = []          # (name, start, end) ns
        self.host: dict[str, tuple[int, int]] = {}             # clock -> (start, stop) ns

    def profile_call(self, fn, spans: list, label: str):
        """Run ``fn()`` under the profiler; returns what it returned."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()            # its own set-up takes seconds: not the call's
        torch.cuda.synchronize()
        t0 = (time.time_ns(), time.monotonic_ns(), time.perf_counter_ns())
        out = fn()
        torch.cuda.synchronize()
        t1 = (time.time_ns(), time.monotonic_ns(), time.perf_counter_ns())
        prof.stop()
        spans.append((label, t0[2], t1[2]))
        self.host = {"time": (t0[0], t1[0]), "monotonic": (t0[1], t1[1]),
                     "perf_counter": (t0[2], t1[2])}
        self.events = device_events(prof)
        return out


def _ns(evt, what: str) -> int:
    f = getattr(evt, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(evt, f"{what}_us")() * 1000)


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device-side event of the profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = _ns(e, "start")
        out.append((e.name(), start, start + _ns(e, "duration")))
    return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _clock(events, host: dict) -> str | None:
    """The host clock the profiler's timestamps are in: the one whose profiled
    stretch holds the events (within a second)."""
    lo = min(s for _, s, _ in events)
    hi = max(e for _, _, e in events)
    for name, (a, b) in host.items():
        if a - 1_000_000_000 <= lo and hi <= b + 1_000_000_000:
            return name
    return None


def reduce(sl: Slice, spans: list[tuple[str, int, int]]) -> dict | None:
    """The slice's numbers: ``busy_s`` (union of device intervals inside the
    profiled stretch), ``window_s`` (its host length), ``gqmm_s``, the top
    kernels by time and the longest idle gaps, labelled by ``spans`` ((label,
    start, end) in ``perf_counter`` ns). None where no device event was
    recorded."""
    if not sl.events:
        return None
    clock = _clock(sl.events, sl.host)
    if clock is not None:
        a, b = sl.host[clock]
        shift = sl.host["perf_counter"][0] - a
    else:                       # unknown clock: the events' own extent
        a = min(s for _, s, _ in sl.events)
        b = max(e for _, _, e in sl.events)
        shift = None
    clipped = [(n, max(s, a), min(e, b)) for n, s, e in sl.events if e > a and s < b]
    busy = union([(s, e) for _, s, e in clipped])
    by_name: dict[str, float] = {}
    gqmm = 0.0
    for n, s, e in clipped:
        sec = (e - s) / 1e9
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + sec
        if PROJECTION_KERNEL.search(n):
            gqmm += sec
    gaps, prev = [], a
    for s, e in busy + [(b, b)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def label(g0: int, g1: int) -> str:
        if shift is None:
            return "unaligned"
        mid = (g0 + g1) // 2 + shift
        for name, s0, s1 in spans:
            if s0 <= mid < s1:
                return name
        return "between calls"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9, "window_s": (b - a) / 1e9,
            "gqmm_s": gqmm, "events": len(clipped), "clock": clock,
            "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[label(g0, g1), (g1 - g0) / 1e9] for g0, g1 in longest]}


def difference(whole: dict, part: dict) -> dict:
    """The numbers of ``whole`` less those of ``part``, a call that ran the
    same prefill groups alone: its decode steps' busy, host and projection
    seconds, tokens and work."""
    out = {k: whole[k] - part[k] for k in ("busy_s", "window_s", "gqmm_s", "tokens")}
    out["work"] = whole["work"] + part["work"].scaled(-1)
    out["gqmm_work"] = whole["gqmm_work"] + part["gqmm_work"].scaled(-1)
    return out
