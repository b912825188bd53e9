"""ttft_p50_ms.ttft: the median of the same call latencies as ttft_p95_ms,
from the harness's span around each call."""

import statistics


def read(run):
    lat = run.latencies_ms
    return statistics.median(lat) if lat else None
