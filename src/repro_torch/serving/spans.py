"""Host spans of the serving loop: what the host was doing, and when.

One recorder for the whole port, off by default. Each span site reads the
module flag ``ON`` once; while it is False a site reads no clock, allocates
nothing and makes no context-manager object. :func:`record` turns it on::

    from repro_torch.serving import spans

    with spans.record() as recs:
        serve_ragged(engine, requests, 64, mode="paged")
    for s in recs:                      # Span(name, start_ns, end_ns, parent, attrs)
        ...

A span is one :class:`Span`: its name, its start and end as
``time.perf_counter_ns()``, the index in the list of its parent (the
innermost span open when it began; -1 for none), and a few attributes, counts
taken at the same boundary. The list is the recording's, in the order the
spans began, but for ``request`` spans, which are appended whole at their
finish; it stays readable after the block. Spans are recorded from the one
thread that serves. Nothing is written out: whoever holds the list does
that.

The spans (sites in ``serving/core.py`` and ``serving/graphs.py``):

- ``serve`` (``requests``, ``slots``): one ``SchedulerCore.serve`` call.
- ``admit`` (``admitted``): an admission wave's host work: ``can_admit``,
  ``on_admit``, ``pad_bucket``.
- ``prefill`` (``rows``, ``length``): one group's ``prefill_insert``: load,
  replay, copies.
- ``prefill.readback``: the wave's first tokens to the host.
- ``round.prepare`` (``live``): ``before_round``, ``check_positions``, the
  sanitizer's ``pre_round`` and the round's step count (a speculative
  round's drafts).
- ``round.replay`` (``steps``): ``decode_round`` / ``verify_round`` up to
  the returned device tensors.
- ``round.readback``: the round's one transfer to the host.
- ``round.commit`` (``finished``): the per-slot loop after it, finishes
  included.
- ``program.replay`` (``program``, its name): one ``Program.replay``, of
  every program.
- ``request`` (``id``, ``admit_ns``, ``first_token_ns``, ``tokens``): one a
  request, from entering ``serve`` (its arrival: the loop is closed) to its
  finish.

``round.replay``'s ``steps`` is the decode steps the round counted (read back
with its tokens: a round that stops at EOS replays past it); its
``program.replay`` children count the replays. ``first_token_ns`` is when
the readback that delivered the request's first token returned; ``tokens``
its delivered tokens (EOS included). ``request`` spans overlap each other;
they are added whole at the finish, with ``serve`` as their parent.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

__all__ = ["ON", "Span", "add", "begin", "end", "note", "record"]

ON = False                      # the flag every span site reads

_recs: list = []                # the recording's spans (an open one: its begin tuple)
_open: list[int] = []           # indices of the open spans, innermost last


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: dict


def begin(name: str, **attrs) -> int:
    """Open a span (recording must be on); returns its index."""
    i = len(_recs)
    _recs.append((name, time.perf_counter_ns(), _open[-1] if _open else -1, attrs))
    _open.append(i)
    return i


def end(i: int, **attrs) -> int:
    """Close span ``i``, and any span opened inside it still open (an
    exception passed through them), at one time; returns that time."""
    if i not in _open:
        raise RuntimeError(f"span {i} is not open")
    t = time.perf_counter_ns()
    while _open:
        j = _open.pop()
        name, t0, parent, a = _recs[j]
        if j == i:
            a.update(attrs)
        _recs[j] = Span(name, t0, t, parent, a)
        if j == i:
            break
    return t


def note(i: int, **attrs) -> None:
    """Set attributes of span ``i``, open or closed (a count known only
    after it closed)."""
    _recs[i][-1].update(attrs)


def add(name: str, start_ns: int, end_ns: int, parent: int, **attrs) -> None:
    """A span whose ends the caller read (one that does not nest, such as a
    request's): appended closed."""
    _recs.append(Span(name, start_ns, end_ns, parent, attrs))


@contextlib.contextmanager
def record():
    """Record every span opened in the block; yields the list they go to."""
    global ON, _recs
    if ON:
        raise RuntimeError("spans are already being recorded")
    _recs, ON = [], True
    recs = _recs
    try:
        yield recs
    finally:
        ON = False
        if _open:
            end(_open[0])
