"""Capture counts at run time: the port's counterpart of the reference's
``JitTraceCounter`` (``repro/analysis/recompile.py``).

The serving programs are built to capture ONCE per signature
(``serving/graphs.py``: a ``generate`` signature's prefill and decode step,
a serve's decode step, its prefill once per group size and bucket length).
A capture per call, from a key that varies where it should not, would
multiply a step's latency by the capture time.
:class:`CaptureCounter` counts program builds per name while it is active,
with the full key of each. The reference module's static half (``jax.jit``
inside a loop) has no counterpart here yet.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from repro_torch.serving import graphs


class CaptureCounter:
    """Counts program builds per program name while active.

    >>> with CaptureCounter() as cc:
    ...     engine.generate(batch, 8)
    ...     engine.generate(batch, 8)
    >>> cc.counts["generate.decode"]
    1
    """

    def __init__(self):
        self.counts: Counter[str] = Counter()
        self.keys: dict[str, list[tuple]] = defaultdict(list)

    def _record(self, name: str, key: tuple) -> None:
        self.counts[name] += 1
        self.keys[name].append(key)

    def __enter__(self):
        graphs.BUILD_LISTENERS.append(self._record)
        return self

    def __exit__(self, *exc):
        graphs.BUILD_LISTENERS.remove(self._record)
        return False

    def total(self) -> int:
        return sum(self.counts.values())

    def assert_builds(self, name: str, expected: int) -> None:
        got = self.counts.get(name, 0)
        if got != expected:
            raise AssertionError(
                f"`{name}` built {got}x, expected exactly {expected}: a rebuild means a "
                f"key varied per call (all counts: {dict(self.counts)})")
