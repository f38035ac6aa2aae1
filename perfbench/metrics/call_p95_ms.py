"""``call_p95_ms``: the 95th percentile of every window call's latency,
call to synchronised return (host clock), in milliseconds."""

import statistics


def read(run):
    lat = run.latencies
    return 1e3 * (statistics.quantiles(lat, n=100, method="inclusive")[94] if len(lat) > 1 else lat[0])
