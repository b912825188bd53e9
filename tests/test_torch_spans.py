"""The serving loop's host spans (``repro_torch.serving.spans``) on reduced
TinyLlama on the CPU: every span closed and inside its parent, one
``request`` span a request with its times in order, the round spans
agreeing with the scheduler's counters, ``generate``'s replays, nothing
recorded while the recorder is off, and the same tokens with it on and
off."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving import batching, paged, spans  # noqa: E402
from repro_torch.serving.core import Request  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CACHE_LEN = 40
PROMPTS = [[5, 3], [7, 1, 4], list(range(1, 11)), list(range(2, 14)), [9] * 6,
           list(range(30, 39))]
BUDGETS = [2, 7, 3, 5, 1, 4]
ROUND = ("round.prepare", "round.replay", "round.readback", "round.commit")


@pytest.fixture(scope="module")
def tree():
    return bridge.init_params_numpy(load_config("tinyllama-1.1b").reduced(), seed=21)


def _engine(tree, eos_id=None):
    cfg = load_config("tinyllama-1.1b").reduced()
    return InferenceEngine(build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=CACHE_LEN, eos_id=eos_id, device="cpu")


def _requests():
    return [Request(i, list(p), max_new=b) for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]


def _scheduler(engine, mode, spec_k=None):
    if mode == "paged":
        return paged.PagedScheduler(engine, slots=3, chunk=4, block_size=8, spec_k=spec_k)
    return batching.SlotScheduler(engine, slots=3, chunk=4, spec_k=spec_k)


def _check_tree(recs):
    """Every span closed, and each inside its parent."""
    assert recs and all(isinstance(s, spans.Span) for s in recs)
    for s in recs:
        assert s.start_ns <= s.end_ns, s
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)


def _named(recs, name):
    return [s for s in recs if s.name == name]


def _eos(tree):
    """Request 1's third token of a run without EOS: it stops that request
    mid-round when made the EOS."""
    free = _scheduler(_engine(tree), "continuous").serve(_requests(), 6)
    return int(free[1].tokens[2])


@pytest.mark.parametrize("mode,eos,spec_k", [("paged", False, None),
                                              ("continuous", False, None),
                                              ("paged", True, None),
                                              ("paged", False, 2)])
def test_serve_spans_nest_and_agree_with_the_counters(tree, mode, eos, spec_k):
    engine = _engine(tree, _eos(tree) if eos else None)
    sched = _scheduler(engine, mode, spec_k)
    off = sched.serve(_requests(), 6)
    with spans.record() as recs:
        out = sched.serve(_requests(), 6)
    assert not spans.ON
    for a, b in zip(off, out):                       # the same tokens on and off
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.length == b.length
    _check_tree(recs)

    (serve,) = _named(recs, "serve")
    assert serve.parent == -1 and serve.attrs == {"requests": len(PROMPTS), "slots": 3}
    si = recs.index(serve)
    reqs = _named(recs, "request")
    assert sorted(s.attrs["id"] for s in reqs) == list(range(len(PROMPTS)))
    for s in reqs:
        a = s.attrs
        assert s.parent == si
        assert s.start_ns <= a["admit_ns"] <= a["first_token_ns"] <= s.end_ns
        assert a["tokens"] == out[a["id"]].length

    replays = _named(recs, "round.replay")
    assert len(replays) == sched.last_rounds
    assert sum(s.attrs["steps"] for s in replays) == sched.last_decode_steps
    assert len(_named(recs, "round.commit")) == sched.last_rounds
    commits = _named(recs, "round.commit")
    assert sum(c.attrs["finished"] for c in commits) == sum(
        any(c.start_ns <= s.end_ns <= c.end_ns for c in commits) for s in reqs)
    for name in ROUND + ("admit", "prefill", "prefill.readback"):
        assert all(recs[s.parent] is serve for s in _named(recs, name)), name
    assert sum(s.attrs["admitted"] for s in _named(recs, "admit")) == len(PROMPTS)
    assert sum(s.attrs["rows"] for s in _named(recs, "prefill")) == len(PROMPTS)
    # a round's spans follow one another in the loop's order
    order = [s.name for s in recs if s.name in ROUND]
    assert order == list(ROUND) * sched.last_rounds

    progs = _named(recs, "program.replay")
    inside = {recs[p.parent].name for p in progs}
    assert inside == {"prefill", "round.replay"}
    for rp in replays:
        kids = [p for p in progs if recs[p.parent] is rp]
        assert len(kids) >= rp.attrs["steps"] >= 1
        kind = "paged" if mode == "paged" else "contiguous"
        assert all(k.attrs["program"] == f"{kind}.{'verify' if spec_k else 'decode'}"
                   for k in kids)


def test_generate_records_its_replays(tree):
    """``generate`` opens no span of its own: its replays are top-level
    ``program.replay`` spans, one prefill and one a decode step."""
    engine = _engine(tree)
    toks = np.asarray([PROMPTS[2], PROMPTS[3][:10]], np.int64)
    off = engine.generate({"tokens": toks}, 5)
    with spans.record() as recs:
        res = engine.generate({"tokens": toks}, 5)
    np.testing.assert_array_equal(off.tokens.numpy(), res.tokens.numpy())
    _check_tree(recs)
    assert {s.name for s in recs} == {"program.replay"}
    assert [p.attrs["program"] for p in recs] == ["generate.prefill"] + ["generate.decode"] * 5
    assert all(p.parent == -1 for p in recs)


def test_recorder_off_records_nothing(tree):
    engine = _engine(tree)
    with spans.record() as recs:
        pass
    assert recs == []
    sched = _scheduler(engine, "paged")
    sched.serve(_requests(), 6)
    engine.generate({"tokens": np.asarray([PROMPTS[2]], np.int64)}, 3)
    assert recs == [] and spans._recs is recs and not spans._open


def test_serve_that_raises_closes_its_spans(tree, monkeypatch):
    engine = _engine(tree)
    sched = _scheduler(engine, "paged")

    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(sched.adapter, "decode_round", broken)
    with spans.record() as recs:
        with pytest.raises(RuntimeError, match="planted"):
            sched.serve(_requests(), 6)
    _check_tree(recs)
    assert [s.name for s in recs if s.name == "serve"] == ["serve"]
    assert _named(recs, "round.replay")[-1].end_ns == recs[0].end_ns
    assert not spans._open and not spans.ON


def test_record_does_not_nest():
    with spans.record():
        with pytest.raises(RuntimeError, match="already"):
            with spans.record():
                pass
    assert not spans.ON


def test_end_refuses_a_span_that_is_not_open():
    with spans.record() as recs:
        outer = spans.begin("outer")
        inner = spans.begin("inner")
        spans.end(inner)
        with pytest.raises(RuntimeError, match="not open"):
            spans.end(inner)
        assert spans._open == [outer]
        spans.end(outer)
    assert [s.name for s in recs] == ["outer", "inner"]
    assert recs[1].parent == 0
