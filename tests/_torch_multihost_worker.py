"""Worker for the port's two-process test of ``dist/multihost`` (run by
tests/test_torch_dist.py, one subprocess per simulated host): the
counterpart of tests/_multihost_worker.py over ``torch.distributed``
with the gloo backend.

Each rank keeps its own half of a deterministic global stream
(``global_frame_batch``), computes a per-frame result on its own mesh,
and only the results cross processes (``gather_frames``); rank 0 checks
them against the whole batch computed in one process.

Usage: python _torch_multihost_worker.py <rank> <port> <out_json>
"""

import datetime
import json
import os
import sys

RANK = int(sys.argv[1])
PORT = sys.argv[2]
OUT = sys.argv[3]

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from i3dr_stereo_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from i3dr_stereo_tpu_torch.dist.multihost import (  # noqa: E402
    gather_frames, global_frame_batch)


def main() -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{PORT}",
                            world_size=2, rank=RANK,
                            timeout=datetime.timedelta(seconds=60))
    n_local = 4
    B_local = n_local  # one frame per local device
    B = 2 * B_local
    H, W = 16, 24

    rng = np.random.default_rng(0)
    L = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    R = 2.0 * L + 1.0

    mesh = make_mesh(n_local, 1, ["cpu"] * n_local)
    part = slice(RANK * B_local, (RANK + 1) * B_local)
    gl, gr = global_frame_batch(mesh, L[part], R[part])
    assert gl.shape == (B, H, W) and gl.offset == RANK * B_local, gl
    assert len(gl.shards) == n_local

    vals = gather_frames((gl.local() + gr.local()).sum(dim=(1, 2)))
    if RANK == 0:
        expected = (torch.from_numpy(L) + torch.from_numpy(R)).sum(dim=(1, 2))
        with open(OUT, "w") as f:
            json.dump({"ok": bool(torch.equal(vals, expected)),
                       "processes": dist.get_world_size(),
                       "frames": int(vals.shape[0])}, f)
    dist.destroy_process_group()


main()
