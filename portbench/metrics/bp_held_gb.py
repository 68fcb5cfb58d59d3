"""bp_held_gb: GB that dense BP holds between its stages, the largest
``held_bytes`` of a frame's ``bp.*`` spans (``matchers/bp.py``:
``torch.cuda.memory_allocated`` at the end of ``bp.data_cost``, each
``bp.level`` and ``bp.belief``, counted on the host) ÷ 1e9, the largest
over the window's frames after the traced ones. It is not the frame's
peak: a level's span ends after its ping-pong buffer is freed, so it
reads the pyramid and one message volume. A program without those
spans, or a run off the card, reads nothing."""

from portbench import spans

PREFIX = "bp."


def read(run):
    got = spans.frames(run, traced=False)
    if got is None:
        return None
    held = [s.attrs["held_bytes"] for s in got.spans
            if s.name.startswith(PREFIX) and "held_bytes" in s.attrs]
    return max(held) * 1e-9 if held else None
