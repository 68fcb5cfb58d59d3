"""``pinned_hit`` on spans made up for it: nothing where no ``node.copy``
span carries ``pinned`` (the parent's program, or the CPU route), and the
share of the copied bytes the pool already held where some were fresh."""

from types import SimpleNamespace

import pytest

from portbench import manifest, spans
from portbench.tests.conftest import REPO

FRAMES = 2


def copy(nbytes, **attrs):
    return SimpleNamespace(name="node.copy", attrs=dict(bytes=nbytes,
                                                        **attrs))


@pytest.fixture
def read(monkeypatch):
    """The reader over ``FRAMES`` frames of the spans given."""
    def on(span_list):
        monkeypatch.setattr(spans, "frames", lambda run, traced: (
            None if traced else spans.Frames(span_list, FRAMES)))
        return manifest.reader(REPO, "pinned_hit.sgbm_1920.replay").read(
            SimpleNamespace())
    return on


def test_no_pinned_span_reads_nothing(read, monkeypatch):
    assert read([copy(100), copy(20),
                 SimpleNamespace(name="node.frame", attrs={})]) is None
    assert read([]) is None
    monkeypatch.setattr(spans, "frames", lambda run, traced: None)
    assert manifest.reader(REPO, "pinned_hit").read(SimpleNamespace()) \
        is None


@pytest.mark.parametrize("fresh,want", [
    ((0, 0, 0), 100.0),
    ((60, 0, 0), 100.0 * (1 - 60 / 400)),
    ((60, 20, 300), 100.0 * (1 - 380 / 400)),
    ((60, 40, 300), 0.0),
])
def test_the_share_of_bytes_reused(read, fresh, want):
    sizes = (60, 40, 300)
    got = read([copy(n, pinned=1, fresh=f) for n, f in zip(sizes, fresh)]
               + [copy(1000)])        # a CPU array: not the pool's
    assert got == pytest.approx(want, rel=1e-12)
