"""pinned_hit: % of the bytes the graph node copies to the host that went
into page-locked buffers its pool already held, over the ``node.copy``
spans that carry ``pinned`` (``bridge/nodes.py:GenerateDisparityNode``'s
copies of a card's outputs): 100 × (1 − Σ ``fresh`` ÷ Σ ``bytes``), where
``fresh`` is the bytes the pool had to allocate anew, over the window's
frames after the traced ones. A program without the pool, or a run off
the card, carries no ``pinned`` and reads nothing."""

from portbench import spans


def read(run):
    got = spans.frames(run, traced=False)
    if got is None:
        return None
    pinned = [s.attrs for s in got.named("node.copy") if "pinned" in s.attrs]
    total = sum(a["bytes"] for a in pinned)
    if not total:
        return None
    return 100.0 * (1.0 - sum(a["fresh"] for a in pinned) / total)
