"""device_activities: device activities (kernels, copies, memsets) a
frame in the profiler's window of the first traced frames: what the
matcher's schedule (``matchers/pyramid.py``, ``matchers/registry.py``)
asks of the card, the node's copies included."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.frames:
        return None
    return len(t.device) / t.frames
