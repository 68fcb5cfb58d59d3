"""Probe of the host's work a kernel call costs on the GPU machine: the
host clock around 200 calls of each piece of the remap's and the census
transform's wrappers (no synchronisation inside the loop; 200 launches
stay below the launch queue's depth, so the host is never held by the
card), at 2448x2048 uint8 cubic on the distorted rig of
``chip_smoke.py`` and at level 0's census shape. Pieces: the stream
lookup (``torch.cuda.current_stream`` and the raw-stream call), the
device context of ``_build.launch``, an output allocation, the checks,
the C entry alone, and the whole wrappers.

    python3 kernel_probes/probe6.py      # from the repository root
"""
import json, subprocess, sys, time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from i3dr_stereo_tpu_torch import _build  # noqa: E402


def host_us(fn, n=200, warm=20):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    import chip_smoke as cs
    from i3dr_stereo_tpu_torch.core import camera
    from i3dr_stereo_tpu_torch.ops import rectify
    from i3dr_stereo_tpu_torch.ops.census import census_transform_pair
    dev = torch.device("cuda", 0)
    lib = _build.library()
    rig = cs.distorted_rig(camera)
    m, m2 = (rectify.make_rectify_map(c, device=dev) for c in (rig.left, rig.right))
    H, W = m.flat_idx.shape
    rng = np.random.default_rng(5)
    src, src2 = (torch.tensor(rng.integers(0, 256, (H, W), dtype=np.uint8), device=dev)
                 for _ in range(2))
    out = torch.empty((1, H, W), dtype=torch.float32, device=dev)
    args = (src.data_ptr(), None, 1, m.flat_idx.data_ptr(), None, m.weights.data_ptr(),
            None, out.data_ptr(), None, 1, H, W, m.src_h, m.src_w, m.pad, m.taps, _build.stream_of(src))
    img = torch.tensor(rng.uniform(0, 255, (1, 2048, 2560)), dtype=torch.float32, device=dev)

    def device_ctx():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "device_ctx": device_ctx,
        "current_device": torch.cuda.current_device,
        "empty_out": lambda: torch.empty((1, H, W), dtype=torch.float32, device=dev),
        "require_cuda": lambda: _build.require_cuda(src, m.flat_idx, m.weights),
        "check": lambda: rectify._check(src, m),
        "c_entry": lambda: lib.i3dr_remap(*args),
        "launch": lambda: _build.launch("i3dr_remap", "remap", dev, *args),
        "remap": lambda: rectify.remap(src, m),
        "rectify_pair": lambda: rectify.rectify_pair(src, src2, m, m2),
        "census_pair": lambda: census_transform_pair(img, img, 9, 9),
    }
    res = {"card": card}
    for rnd in range(2):
        for name in (pieces if rnd == 0 else list(pieces)[::-1]):
            res.setdefault(name, []).append(host_us(pieces[name]))
    for name, t in res.items():
        if name != "card":
            print(f"[{card}] host us a call, {name}: " + " ".join(f"{x:.1f}" for x in t),
                  flush=True)
    print("RESULT " + json.dumps(res), flush=True)


main()
