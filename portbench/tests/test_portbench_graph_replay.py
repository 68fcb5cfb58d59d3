"""``graph_replay`` on spans made up for it: nothing where no
``pyramid.match`` span was recorded (the parent's program, or a cell that
runs no pyramid), 100 where every frame replayed, and the share of frames
for a mix of eager, captured and replayed ones."""

from types import SimpleNamespace

import pytest

from portbench import manifest, spans
from portbench.tests.conftest import REPO


def match(frame, graph):
    return SimpleNamespace(name="pyramid.match", frame=frame,
                           attrs={"graph": graph})


def node(frame):
    return SimpleNamespace(name="node.frame", frame=frame, attrs={})


@pytest.fixture
def read(monkeypatch):
    """The reader over the spans given, as many frames as ``node.frame``
    spans among them."""
    def on(span_list):
        frames = sum(1 for s in span_list if s.name == "node.frame")
        monkeypatch.setattr(spans, "frames", lambda run, traced: (
            None if traced else spans.Frames(span_list, frames)))
        return manifest.reader(
            REPO, "graph_replay.i3drsgm_2448.replay").read(SimpleNamespace())
    return on


def test_no_match_span_reads_nothing(read, monkeypatch):
    assert read([node(1), node(2)]) is None
    monkeypatch.setattr(spans, "frames", lambda run, traced: None)
    assert manifest.reader(REPO, "graph_replay").read(SimpleNamespace()) \
        is None


def test_every_frame_replayed_reads_100(read):
    frames = range(5)
    assert read([node(f) for f in frames]
                + [match(f, "replay") for f in frames]) == 100.0


@pytest.mark.parametrize("graphs,want", [
    (("eager", "capture", "replay", "replay"), 50.0),
    (("eager", "eager", "eager", "eager"), 0.0),
    (("capture", "replay", "replay", "replay"), 75.0),
])
def test_the_share_of_frames_replayed(read, graphs, want):
    got = read([node(f) for f in range(len(graphs))]
               + [match(f, g) for f, g in enumerate(graphs)])
    assert got == pytest.approx(want, rel=1e-12)
