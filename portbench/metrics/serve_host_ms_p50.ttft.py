"""serve_host_ms_p50.ttft: the median, over the window's calls, of the
``serve`` span less its prefill stretch (``prefill_ms_p50.ttft``'s): the
scheduler's look-up, validation, admission, padding and responses. From the
program's own spans (``Run.spans``); None where the run recorded none."""

import statistics

from portbench import spanread


def read(run):
    recs = getattr(run, "spans", None)
    ns = spanread.serve_host_ns(recs) if recs else []
    return statistics.median(ns) / 1e6 if ns else None
