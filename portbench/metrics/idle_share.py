"""idle_share: 1 - busy / wall over the traced frames, in %; busy is the
union of the device's activity spans. In a closed loop wall is the
host's clock from the first traced frame's publish to the last one's
delivery; in an open loop it is the union of the frames' service
intervals (publish to delivery), so the gaps between arrivals do not
count."""

from portbench import trace as tr


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    within = [t.window] if run.rate is None else tr.union(t.spans("frame"))
    return 100.0 * (1.0 - tr.busy(t, within) / tr.length(within))
