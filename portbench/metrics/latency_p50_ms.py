"""latency_p50_ms: the median, over every frame due in the window and
delivered, of the time from its due time to the arrival of its last
output topic (a frame waited for past the close counts its wait)."""

import statistics


def read(run):
    lat = [(f.t_done - f.due) * 1e3 for f in run.frames
           if f.due is not None and f.t_done is not None and not f.error]
    return statistics.median(lat) if lat else None
