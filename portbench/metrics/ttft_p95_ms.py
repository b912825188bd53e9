"""ttft_p95_ms: the 95th percentile, over every call of the window, of the
host time from the call to its one token on the host (each call serves one
request with a budget of one token)."""

import statistics


def read(run):
    lat = run.latencies_ms
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
