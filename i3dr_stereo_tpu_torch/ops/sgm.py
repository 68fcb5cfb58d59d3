"""SGM path directions (torch port of the direction tables of
``i3dr_stereo_tpu.ops.sgm``). The aggregation itself lives in
:mod:`i3dr_stereo_tpu_torch.ops.sgm_fused_t`."""

from __future__ import annotations

from typing import Tuple

# (dy, dx) path directions, named from where the path COMES FROM.
DIRECTIONS_8: Tuple[Tuple[int, int], ...] = (
    (0, 1), (0, -1),          # W->E, E->W  (horizontal)
    (1, 0), (-1, 0),          # N->S, S->N  (vertical)
    (1, 1), (-1, -1),         # NW->SE, SE->NW
    (1, -1), (-1, 1),         # NE->SW, SW->NE
)
# the classic 4-path set (the engine's quick.param:144-147)
DIRECTIONS_4: Tuple[Tuple[int, int], ...] = ((0, 1), (0, -1), (1, 0), (-1, 0))
