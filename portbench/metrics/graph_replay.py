"""graph_replay: % of the window's frames after the traced ones whose
pyramid ran as a replayed CUDA graph: the frames with a ``pyramid.match``
span whose ``graph`` is ``replay`` (``matchers/pyramid.py:PyramidGraphs``),
over the frames read. The other values are ``eager`` (a key's first call,
a CPU tensor or the plain twins) and ``capture``. A program without the
span reads nothing."""

from portbench import spans


def read(run):
    got = spans.frames(run, traced=False)
    if got is None:
        return None
    matches = got.named("pyramid.match")
    if not matches:
        return None
    replayed = {s.frame for s in matches if s.attrs.get("graph") == "replay"}
    return 100.0 * len(replayed) / got.frames
