"""The load generators against a stand-in node on the port's own graph:
the open loop counts latency from the due time, never waits for the
graph, and a stall shows in the 95th percentile."""

import statistics
import time
from types import SimpleNamespace

from i3dr_stereo_tpu_torch.bridge.graph import Graph

from portbench import load, manifest
from portbench.tests.conftest import REPO


class StandIn:
    """Subscribes the raw topics like the matcher node and publishes every
    output topic ``service`` seconds later (``stall`` longer for the pair
    with stamp ``stall_at``)."""

    def __init__(self, graph, service, stall=0.0, stall_at=None):
        self.pipeline = SimpleNamespace(process=self._process)
        self.graph, self.service = graph, service
        self.stall, self.stall_at = stall, stall_at
        self._left = {}
        graph.subscribe("/stereo/left/image_raw", self._on_left)
        graph.subscribe("/stereo/right/image_raw", self._on_right)

    def _process(self, left, right):
        time.sleep(self.service)
        return None

    def _on_left(self, stamp, img):
        self._left[stamp] = img

    def _on_right(self, stamp, img):
        self._left.pop(stamp)
        if stamp == self.stall_at:
            time.sleep(self.stall)
        self.pipeline.process(None, img)
        for t in load.OUTPUTS:
            self.graph.publish(f"/stereo/{t}", stamp, {"t": t})


def drive(rate, seconds, service, stall=0.0, stall_at=None):
    g = Graph()
    node = StandIn(g, service, stall, stall_at)
    pool = SimpleNamespace(left=[0, 1], right=[0, 1])
    drv = load.GraphLoad(g, node.pipeline, pool, seed=3)
    t0, t_end = load.open_loop(drv, seconds, rate)
    drv.close()
    run = SimpleNamespace(frames=[f for f in drv.frames if f.window],
                          t_end=t_end, seconds=seconds)
    return drv, run


def lat(run):
    return [(f.t_done - f.due) * 1e3 for f in run.frames]


def test_open_loop_counts_from_due_time_and_never_waits():
    drv, run = drive(rate=20.0, seconds=1.0, service=0.03)
    assert len(run.frames) == 20
    dues = [f.due for f in run.frames]
    gaps = [b - a for a, b in zip(dues, dues[1:])]
    assert max(abs(g - 0.05) for g in gaps) < 1e-9
    for f in run.frames:
        assert f.t_done >= f.t_pub >= f.due
        assert f.t_enq - f.due < 0.02       # the generator did not wait
    assert min(lat(run)) >= 30.0


def test_a_stall_shows_in_the_p95_and_queues_the_frames_behind_it():
    stall_at = 1000.0 + 5
    drv, run = drive(rate=20.0, seconds=1.5, service=0.02, stall=0.5,
                     stall_at=stall_at)
    p95 = manifest.reader(REPO, "latency_p95_ms").read(run)
    p50 = manifest.reader(REPO, "latency_p50_ms").read(run)
    assert p95 > 400.0 > p50
    # the generator kept its schedule through the stall
    late = [f.t_enq - f.due for f in run.frames]
    assert max(late) < 0.02
    # frames due during the stall waited for it: their latency counts it
    behind = [f for f in run.frames if stall_at < f.stamp <= stall_at + 5]
    assert all((f.t_done - f.due) > 0.2 for f in behind)
    assert statistics.median(lat(run)) < 100.0 or p95 > p50


def test_closed_loop_sends_the_next_pair_after_delivery(monkeypatch):
    monkeypatch.setattr(load, "CHECK_FRAMES", 2)
    g = Graph()
    node = StandIn(g, 0.01)
    pool = SimpleNamespace(left=[0], right=[0])
    drv = load.GraphLoad(g, node.pipeline, pool, seed=1)
    t0, t_end = load.closed_loop(drv, 0.3)
    drv.close()
    fr = drv.frames
    assert len(fr) >= 10
    for a, b in zip(fr, fr[1:]):
        assert b.t_enq >= a.t_done
    assert len(drv.sample) == 2 and all(f.outputs for f in drv.sample)
    run = SimpleNamespace(frames=fr, t_end=t_end, seconds=0.3)
    fps = manifest.reader(REPO, "fps").read(run)
    assert 0 < fps <= len(fr) / 0.3
