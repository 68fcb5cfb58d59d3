"""Device mesh for the stereo engine (torch port of
``i3dr_stereo_tpu.dist.mesh``).

The reference scales by multi-process pipelining and the licensed
engine's multi-GPU switch ("Indices Of GPUs In Stereo Matching",
"MultiGPU Implementation After DSI", ini/quick.param:14,126). The JAX
package's model is a 2D mesh of devices; here it is the same grid of
``torch.device``s, walked by :mod:`~i3dr_stereo_tpu_torch.dist.sharded`:

- ``data``    — frame/batch parallelism (independent stereo pairs),
- ``spatial`` — image-row parallelism within a frame, with halo exchange
  for the SGM paths that cross block boundaries.

A device may appear more than once in the grid. That is how one card
hosts a 1x4 row split (four blocks, one after another, on one GPU), and
how the CPU tests stand in for a machine of many devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` runs row block ``j`` of data shard ``i``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices),
                SPATIAL_AXIS: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """Where sharded functions return their results."""
        return self.devices[0][0]


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data x spatial) mesh from the available devices.

    Defaults: every visible CUDA device, all on the data axis. n_data=None
    infers len(devices) // n_spatial.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_spatial
    need = n_data * n_spatial
    if need > len(devices) or need == 0:
        raise ValueError(f"mesh {n_data}x{n_spatial} needs {need} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(tuple(devices[i * n_spatial:(i + 1) * n_spatial])
                      for i in range(n_data)))
