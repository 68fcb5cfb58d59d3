"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``csrc/*.cu`` are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source and all of them at once,
and linked into one shared library with a plain C interface, loaded with
``ctypes`` — no PyTorch headers, so a cold build takes seconds, not
minutes. The library lands in ``_kernels/<hash>/`` beside
this file (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.

Every C entry point launches one kernel on the stream it is given and
returns ``cudaGetLastError()`` (``i3dr_icp_grid``, which sizes the ICP
kernel's grid, launches nothing); :func:`launch` raises on a non-zero
code and otherwise adds one to that kernel's count in :data:`LAUNCHES`,
so a run can show that its main path went through the kernels.

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit, where only the plain torch twins of the kernels run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels"
LIB_NAME = "libi3dr_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"census_cost": 0, "sgm_sweep": 0, "sgm_sweep_wta": 0,
            "row_gather": 0, "remap": 0, "speckle_ccl": 0, "sgm_volume": 0,
            "fused_census_fwd": 0, "fused_bt_fwd": 0, "census_transform": 0,
            "gauss_rays": 0, "wls_lines": 0, "bp_messages": 0,
            "bp_planes": 0, "tsdf_integrate": 0, "icp_step": 0,
            "bt_box_cost": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry -> argtypes (pointers and the stream as c_void_p: a bare Python
# int would be passed as a 32-bit int and cut)
_SIGNATURES = {
    # cl, cr, C, Cw (or null), B, H, W, NW, D, bpm, H_real, W_real, stream
    "i3dr_census_cost": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # C, wide (C is int16), op, acc16 (or null), acc32 (or null), B, H, W,
    # dy, dx, p1, p2, stream
    "i3dr_sgm_sweep": (_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    # C, acc, acc is float32, disp, B, H, W, dy, dx, p1, p2, subpixel,
    # uniqueness_ratio, stream
    "i3dr_sgm_sweep_wta": (_P, _P, _I, _P, _I, _I, _I, _I, _I, _F, _F, _I,
                           _F, _P),
    # src, idx, q, out, B, H, W, Hq, Wq, radius, stream
    "i3dr_row_gather": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # src0, src1 (or null), src_u8, flat_idx0, flat_idx1 (or null),
    # weights0, weights1 (or null), out0, out1 (or null), B, H, W, src_h,
    # src_w, pad, taps, stream
    "i3dr_remap": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _I, _P),
    # a, b (or null), out_a, out_b (or null), B, H, W, window h, w, stream
    "i3dr_census_transform": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # d, valid, labels, sizes, keep, B, H, W, max_size, max_diff, stream
    "i3dr_speckle_ccl": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # C, u8, out, out_i32, x (or null), acc (or null), acc_kind, B, H, W,
    # D, dy, dx, p1, p2, stream
    "i3dr_sgm_volume": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _P),
    # cl, cr, base, th, C, S, s_i16, B, H, W, NW, D, min_disp, p1, p2, stream
    "i3dr_fused_census_fwd": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _F, _F, _P),
    # left, right, base, th, C, S, s_i16, B, H, W, D, min_disp, p1, p2, stream
    "i3dr_fused_bt_fwd": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                          _F, _P),
    # left, right, out, scratch, B, H, W, D, min_disp, radius, stream
    "i3dr_bt_box_cost": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # d, v, table, out, vout, B, H, W, n_dir, rounds, radius,
    # inv_two_sig2, min_rays, stream
    "i3dr_gauss_rays": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                        _P),
    # a, w, d, u, B, L, N, plane, line, step, wplane, wline, wstep, lam,
    # stream
    "i3dr_wls_lines": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F,
                       _P),
    # data, msgs, out, B, D, H, W, jump, max_disc, inv_d, shared, stream
    "i3dr_bp_messages": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P),
    # data, dvals, msgs, out, B, K, H, W, jump, max_disc, inv_k, stream
    "i3dr_bp_planes": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P),
    # tsdf, weight, depth, X, Y, Z, H, W, K00, K02, K11, K12, rows 0-2 of
    # T_cw (12), origin (3), voxel_size, trunc, stream
    "i3dr_tsdf_integrate": (_P, _P, _P, _I, _I, _I, _I, _I) + (_F,) * 21
    + (_P,),
    # levels, maps (2 a level), dims (H, W, steps), cams (fx, fy, cx, cy,
    # inv_hw), thr2, partials, state, blocks, stream: a whole ICP track
    "i3dr_icp_track": (_I, _P, _P, _P, _F, _P, _P, _I, _P),
    # max_pixels, out blocks: the track kernel's cooperative grid (no launch)
    "i3dr_icp_grid": (_L, _P),
    # out (uint32, blocks * 256), blocks, iters, stream: the popcount-rate
    # probe (blocks * 256 * iters * 8 popcounts); no kernel of any path
    "i3dr_popc_probe": (_P, _I, _I, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact source set is built already.
    nvcc's report (registers, shared memory, spills) is kept beside the
    library as ``build.log``."""
    out = _library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [f for f in _sources() if f.suffix == ".cu"]
    objs = [out.parent / f"{f.stem}.{tag}.o" for f in cus]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(cus, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    (out.parent / "build.log").write_text("".join(logs))
    failed = [(f.name, log) for f, proc, log in zip(cus, procs, logs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}:\n{log[-4000:]}" for name, log in failed))
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(o) for o in objs)],
                          capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed (exit "
                           f"{link.returncode}):\n{link.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.i3dr_error_string.argtypes = [ctypes.c_int]
    lib.i3dr_error_string.restype = ctypes.c_char_p
    return lib


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. The entry points run on the card
    unless the caller asks for the CPU, and never fall back to it: a CUDA
    device that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (pass device=\"cpu\" for the plain "
                           "torch twins)")
    return dev


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected tensors on one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device: 0.2 us a
    call on the host of an NVIDIA H100 machine, where building a
    ``torch.cuda.Stream`` to read it takes 5-6 us
    (``kernel_probes/probe6.py`` at commit 1dd326f)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def launch(entry: str, kernel: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``; raise on a CUDA error, else
    count one launch of ``kernel``. The device is made current only where
    it is not already (a device context costs 3-4 us a call there)."""
    lib = library()
    if device.index == torch.cuda.current_device():
        err = getattr(lib, entry)(*args)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} "
                           f"({lib.i3dr_error_string(err).decode()})")
    LAUNCHES[kernel] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
