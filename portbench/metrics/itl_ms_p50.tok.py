"""itl_ms_p50.tok: the median, over the window's requests of two or more
tokens, of (finish - first token) / (tokens - 1) from their ``request``
spans: the inter-token time a stream sees. From the program's own spans
(``Run.spans``); None where the run recorded none."""

import statistics

from portbench import spanread


def read(run):
    recs = getattr(run, "spans", None)
    ms = spanread.inter_token_ms(recs) if recs else []
    return statistics.median(ms) if ms else None
