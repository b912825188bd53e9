"""The program-span reductions (``portbench/spanread.py``) and the five span
readers on planted span lists and device intervals, and one tiny CPU run of
``run_spans`` with the recorder off and on."""

from __future__ import annotations

import pytest

from portbench import run, spanread, spanrun
from portbench.tests._tiny import CELLS, cell, config, mix, tiny_mix, tiny_shape
from repro_torch.serving.spans import Span

US = 1_000                              # ns


def _call():
    """One serve call: an admission wave of two prefills, then two decode
    rounds (the first followed by a prefill, the second by a round), and two
    requests. Times in us."""
    s = []

    def add(name, a, b, parent, **attrs):
        s.append(Span(name, a * US, b * US, parent, attrs))
        return len(s) - 1

    serve = add("serve", 0, 1000, -1, requests=2, slots=2)
    add("admit", 10, 20, serve, admitted=2)
    p = add("prefill", 20, 100, serve, rows=1, length=64)
    add("program.replay", 30, 90, p, program="paged.prefill")
    add("prefill", 100, 150, serve, rows=1, length=128)
    add("prefill.readback", 150, 300, serve)
    add("round.prepare", 310, 320, serve, live=2)
    r = add("round.replay", 320, 400, serve, steps=2)
    add("program.replay", 330, 340, r, program="paged.decode")
    add("program.replay", 350, 370, r, program="paged.decode")
    add("round.readback", 400, 600, serve)
    add("round.commit", 600, 640, serve, finished=1)
    add("request", 0, 630, serve, id=0, admit_ns=20 * US, first_token_ns=300 * US, tokens=3)
    add("prefill", 700, 760, serve, rows=1, length=64)             # 100 us after readback
    add("prefill.readback", 760, 800, serve)
    add("round.prepare", 800, 805, serve, live=2)
    r = add("round.replay", 805, 850, serve, steps=1)
    add("program.replay", 810, 840, r, program="paged.decode")
    add("round.readback", 850, 900, serve)
    add("round.commit", 900, 990, serve, finished=1)
    add("request", 0, 980, serve, id=1, admit_ns=20 * US, first_token_ns=300 * US, tokens=1)
    return s


def test_round_gaps_replays_and_inter_token_times():
    s = _call()
    assert spanread.round_gaps_ns(s) == [100 * US]        # the last round has no follower
    assert sorted(spanread.decode_replays_ns(s)) == [10 * US, 20 * US, 30 * US]
    assert spanread.inter_token_ms(s) == [pytest.approx(0.165)]   # (630 - 300) / 2 us
    assert spanread.prefill_stretch_ns(s) == {0: 280 * US}        # 20 .. 300
    assert spanread.serve_host_ns(s) == [720 * US]
    assert spanread.replay_stats(s) == {"count": 3, "p50": 20.0, "max": 30.0,
                                       "first_of_round_p50": 20.0}


def test_round_gap_stays_inside_its_call():
    s = _call()
    second = [x._replace(start_ns=x.start_ns + 2000 * US, end_ns=x.end_ns + 2000 * US,
                         parent=x.parent + len(s) if x.parent >= 0 else -1) for x in s]
    assert spanread.round_gaps_ns(s + second) == [100 * US, 100 * US]


def test_exclusive_stretches_tile_each_span():
    s = _call()
    ex = spanread.exclusive(s)
    assert all(a < b for a, b, _ in ex)
    assert all(ex[i][1] <= ex[i + 1][0] for i in range(len(ex) - 1))     # disjoint
    assert sum(b - a for a, b, _ in ex) == 1000 * US                     # the serve span
    by = spanread.host_ms_by_span(s)
    assert by["round.readback"] == pytest.approx(0.25)
    assert by["prefill"] == pytest.approx(0.02 + 0.05 + 0.06)            # less its replay
    assert "request" not in by


def test_idle_by_span_and_gap_labels():
    s = _call()
    gaps = [(-50 * US, 0), (380 * US, 590 * US), (600 * US, 700 * US), (995 * US, 996 * US)]
    by = spanread.idle_by_span(gaps, s)
    assert by[spanread.OUTSIDE] == pytest.approx(50e-6)
    assert by["round.replay"] == pytest.approx(20e-6)
    assert by["round.readback"] == pytest.approx(190e-6)
    assert by["round.commit"] == pytest.approx(40e-6)
    assert by["serve"] == pytest.approx(60e-6 + 1e-6)
    assert sum(by.values()) == pytest.approx(sum(b - a for a, b in gaps) / 1e9)
    label = [spanread.gap_label(a, b, s, "serve_ragged") for a, b in gaps]
    assert label == ["serve_ragged", "round.readback", "serve", "serve"]
    assert spanread.gap_label(335 * US, 338 * US, s, "x") == "program.replay"


def test_commit_overlap_counts_launches_inside_commits():
    s = _call()
    events = [(610 * US, 620 * US), (590 * US, 610 * US), (640 * US, 650 * US),
              (905 * US, 906 * US)]
    assert spanread.commit_overlap(events, s) == 2
    assert spanread.commit_overlap([], s) == 0


def test_decode_view_subtracts_the_prefill_call():
    whole = {"idle_s": 1.0, "idle_by_span": {"round.readback": 0.7, "serve": 0.25,
                                             spanread.OUTSIDE: 0.05},
             "short_gaps": {"count": 100, "s": 0.001}}
    part = {"idle_s": 0.2, "idle_by_span": {"serve": 0.15, spanread.OUTSIDE: 0.05},
            "short_gaps": {"count": 10, "s": 0.0002}}
    d = spanread.decode_view(whole, part)
    assert d["idle_s"] == pytest.approx(0.8)
    assert d["idle_by_span"]["round.readback"] == pytest.approx(0.7)
    assert d["inside_pct"] == pytest.approx(100.0)
    assert d["short_gaps"]["count"] == 90


@pytest.mark.parametrize("metric,value", [("round_gap_ms.tok", 0.1),
                                          ("replay_us.tok", 20.0),
                                          ("itl_ms_p50.tok", 0.165),
                                          ("prefill_ms_p50.ttft", 0.28),
                                          ("serve_host_ms_p50.ttft", 0.72)])
def test_span_readers(metric, value):
    read = run.reader(metric)
    assert read(run.Run(spans=_call())) == pytest.approx(value)
    assert read(run.Run(spans=[])) is None
    assert read(run.Run(trace=None)) is None            # a run that recorded no spans


@pytest.mark.parametrize("name", CELLS)
def test_run_spans_tiny_off_and_on(name):
    """A CPU run: a window with the recorder off, then one with it on, whose
    spans give the cell's span metrics."""
    c = cell(name)
    out = spanrun.run_spans(name, 4_000_000_011, 0.2, ["off", "on"], False, device="cpu",
                            shape=tiny_shape(config(c["config"])["port"]),
                            mix=tiny_mix(mix(c["traffic"])))
    off, on = out["windows"]
    assert "metrics" not in off and on["recorded"] > 0
    assert on["metrics"] and set(on["metrics"]) <= set(spanrun.SPAN_METRICS)
    assert all(v is not None and v > 0 for v in on["metrics"].values()), on["metrics"]
    assert on["host_ms_by_span"]["prefill.readback"] > 0


def test_slice_view_reads_the_trace_on_the_span_clock():
    """Device events on the profiler's clock (``time``), shifted onto the
    spans' ``perf_counter`` clock: gaps labelled, divided and counted."""
    from portbench import trace as tr

    base, pc = 10_000_000_000, 0                 # the call starts at perf_counter 0
    sl = tr.Slice()
    sl.host = {"time": (base, base + 1000 * US), "monotonic": (1, 2),
               "perf_counter": (pc, pc + 1000 * US)}
    sl.events = [("k", base + a * US, base + b * US) for a, b in
                 ((20, 380), (590, 600), (605, 612), (700, 995))]
    v = spanread.slice_view(sl, _call(), "serve_ragged")
    assert v["idle_s"] == pytest.approx((20 + 210 + 5 + 88 + 5) * 1e-6)
    assert v["idle_gaps"][0] == ["round.readback", pytest.approx(210e-6)]
    assert v["short_gaps"] == {"count": 2, "s": pytest.approx(10e-6)}
    assert v["commit_overlap"] == 1                  # the event at 605 us
    assert sum(v["idle_by_span"].values()) == pytest.approx(v["idle_s"])
    assert v["idle_by_span"].get(spanread.OUTSIDE, 0.0) == pytest.approx(0.0)
