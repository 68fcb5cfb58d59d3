"""latency_p95_ms: the 95th percentile of the same samples as
latency_p50_ms, every frame due in the window (not of chunk medians),
linear between the two nearest ranks."""

import statistics


def read(run):
    lat = [(f.t_done - f.due) * 1e3 for f in run.frames
           if f.due is not None and f.t_done is not None and not f.error]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
