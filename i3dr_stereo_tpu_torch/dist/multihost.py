"""Multi-host ingest + scaling measurement (torch port of
``i3dr_stereo_tpu.dist.multihost``).

Reference reality: one machine, many processes, GigE cameras with jumbo
frames (README.md:67-85). Here each process ingests its own cameras'
frames onto its own devices: :func:`global_frame_batch` places them on
the process's mesh and says where they sit in the global batch, no pixel
crosses hosts, and only results are gathered (:func:`gather_frames`,
``torch.distributed.all_gather``). The process group is the caller's:
``torch.distributed.init_process_group`` with an address, world size and
rank (gloo on CPU tensors, NCCL on CUDA ones).

Also provides the scaling-efficiency harness for BASELINE config 5
(throughput at 1 device / N devices, efficiency = T_N / (N * T_1)).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from i3dr_stereo_tpu_torch.dist.mesh import DATA_AXIS, Mesh, make_mesh


@dataclasses.dataclass
class FrameBatch:
    """This process's frames of a global (B, H, W) batch, split over the
    mesh's data axis: ``shards[i]`` lies on ``mesh.devices[i][0]``."""

    shards: List[torch.Tensor]
    shape: tuple          # the global batch's shape
    offset: int           # index of this process's first frame in it

    def local(self) -> torch.Tensor:
        """This process's frames, in order, on the first shard's device."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_frame_batch(mesh: Mesh, local_left, local_right):
    """Place this process's (B_local, H, W) frames on the mesh's data
    shards. With one process the global batch is the local one. Under a
    process group of more than one rank each rank keeps its own frames
    (every rank holds the same number), so the global batch is
    (world * B_local, H, W) and this rank's part starts at
    rank * B_local."""
    world, rank = _world()
    n = mesh.shape[DATA_AXIS]
    out = []
    for x in (local_left, local_right):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{n} data shards")
        b = x.shape[0] // n
        out.append(FrameBatch(
            [x[i * b:(i + 1) * b].to(mesh.devices[i][0]) for i in range(n)],
            (x.shape[0] * world,) + tuple(x.shape[1:]), rank * x.shape[0]))
    return tuple(out)


def gather_frames(x: torch.Tensor) -> torch.Tensor:
    """Every rank's per-frame results ``x`` (B_local, ...) concatenated
    in rank order, which is the global batch's order; ``x`` itself with
    one process."""
    world, _ = _world()
    if world == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _synchronize(mesh: Mesh) -> None:
    for dev in {d for row in mesh.devices for d in row}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure_scaling(step_factory: Callable[[Mesh], Callable],
                    make_batch: Callable[[int], tuple],
                    device_counts: List[int],
                    iters: int = 3,
                    devices: Optional[Sequence] = None) -> Dict[int, dict]:
    """Throughput at several mesh sizes; efficiency vs the smallest.

    step_factory(mesh) -> step; make_batch(n_data) -> args with a batch
    divisible by n_data. The meshes are built from ``devices`` (default:
    every visible CUDA device); host clock, after the devices finish.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    results: Dict[int, dict] = {}
    base = None
    for n in device_counts:
        if n > len(devices):
            continue
        mesh = make_mesh(n, 1, devices)
        step = step_factory(mesh)
        args = make_batch(n)
        step(*args)
        _synchronize(mesh)
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*args)
        _synchronize(mesh)
        dt = (time.perf_counter() - t0) / iters
        frames = args[0].shape[0]
        thr = frames / dt
        if base is None:
            base = (n, thr)
        eff = thr / (base[1] * n / base[0])
        results[n] = {"devices": n, "frames_per_s": thr,
                      "efficiency": eff}
    return results
