"""csbp_held_mb: MB that CSBP holds on the card, the largest
``held_bytes`` of a frame's ``csbp.*`` spans ÷ 1e6, the largest over the
window's frames after the traced ones. Where CSBP runs eagerly the stage
spans count it (``matchers/bp.py:_constant_space_match``:
``torch.cuda.memory_allocated`` at the end of ``csbp.coarse``,
``csbp.select``, each ``csbp.level`` and ``csbp.belief``, counted on the
host): everything the allocator holds for tensors then, the graph's own
buffers too, and not the frame's peak, since a level's span ends after
its ping-pong buffer is freed. Where it replays its CUDA graph, the
frame's one span is ``csbp.match``, whose count adds to the allocator's
tensors the free bytes of the graph's memory pool, where a replay's
intermediates live. A program without those spans, or a run off the
card, reads nothing."""

from portbench import spans

PREFIX = "csbp."


def read(run):
    got = spans.frames(run, traced=False)
    if got is None:
        return None
    held = [s.attrs["held_bytes"] for s in got.spans
            if s.name.startswith(PREFIX) and "held_bytes" in s.attrs]
    return max(held) * 1e-6 if held else None
