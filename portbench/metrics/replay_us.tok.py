"""replay_us.tok: the median host us of one ``program.replay`` of the decode
program (the replays inside ``round.replay`` spans: the paged decode step)
in the window. From the program's own spans (``Run.spans``); None where the
run recorded none."""

import statistics

from portbench import spanread


def read(run):
    recs = getattr(run, "spans", None)
    ns = spanread.decode_replays_ns(recs) if recs else []
    return statistics.median(ns) / 1e3 if ns else None
