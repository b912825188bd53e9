"""round_gap_ms.tok: the median, over the window's decode rounds, of the host
ms from a round's ``round.readback`` returning to the start of the next span
of its call that launches device work (``round.replay`` or ``prefill``): the
card has nothing queued in that stretch. From the program's own spans
(``Run.spans``); None where the run recorded none."""

import statistics

from portbench import spanread


def read(run):
    recs = getattr(run, "spans", None)
    gaps = spanread.round_gaps_ns(recs) if recs else []
    return statistics.median(gaps) / 1e6 if gaps else None
