"""prefill_ms_p50.ttft: the median, over the window's calls, of the host ms
from the wave's first ``prefill`` span starting to its ``prefill.readback``
returning. From the program's own spans (``Run.spans``); None where the run
recorded none."""

import statistics

from portbench import spanread


def read(run):
    recs = getattr(run, "spans", None)
    ns = list(spanread.prefill_stretch_ns(recs).values()) if recs else []
    return statistics.median(ns) / 1e6 if ns else None
