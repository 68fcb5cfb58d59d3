"""ctypes bindings for the native shared-memory frame ring.

The .so is compiled on demand with g++ (cached next to the source; no
pybind11 needed). See shm_ring.cpp for the transport design.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "shm_ring.cpp")
_SO = os.path.join(_DIR, "libi3dr_host.so")
_lock = threading.Lock()
_lib = None


def build_native(force: bool = False) -> str:
    """Compile the host runtime library if needed; returns the .so path."""
    with _lock:
        if force or (not os.path.exists(_SO)
                     or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                   _SRC, "-o", _SO, "-lrt", "-pthread"]
            subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = build_native()
    lib = ctypes.CDLL(so)
    lib.i3dr_ring_create.restype = ctypes.c_void_p
    lib.i3dr_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
    lib.i3dr_ring_open.restype = ctypes.c_void_p
    lib.i3dr_ring_open.argtypes = [ctypes.c_char_p]
    lib.i3dr_ring_push.restype = ctypes.c_int
    lib.i3dr_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint32]
    lib.i3dr_ring_pop.restype = ctypes.c_int
    lib.i3dr_ring_pop.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_void_p, ctypes.c_uint32]
    lib.i3dr_ring_peek_stamp.restype = ctypes.c_int
    lib.i3dr_ring_peek_stamp.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_double)]
    lib.i3dr_ring_drop.restype = ctypes.c_int
    lib.i3dr_ring_drop.argtypes = [ctypes.c_void_p]
    for f in ("i3dr_ring_size", "i3dr_ring_capacity", "i3dr_ring_frame_bytes"):
        getattr(lib, f).restype = ctypes.c_uint32
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.i3dr_ring_close.restype = None
    lib.i3dr_ring_close.argtypes = [ctypes.c_void_p]
    lib.i3dr_ring_unlink.restype = ctypes.c_int
    lib.i3dr_ring_unlink.argtypes = [ctypes.c_char_p]
    lib.i3dr_pair_pop.restype = ctypes.c_int
    lib.i3dr_pair_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_double,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_uint32]
    _lib = lib
    return lib


class FrameRing:
    """A named SPSC frame ring in POSIX shared memory.

    The analog of the reference's /tmp/ros_mem_<serial> shm segment
    (tiscamera.py:70-77): one per camera, producer = driver process,
    consumer = the pipeline host.
    """

    def __init__(self, name: str, *, slots: int = 8,
                 frame_shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.uint8, create: bool = True):
        lib = _load()
        self._lib = lib
        self.name = name if name.startswith("/") else "/" + name
        self.dtype = np.dtype(dtype)
        if create:
            assert frame_shape is not None
            self.frame_shape = tuple(frame_shape)
            nbytes = int(np.prod(self.frame_shape)) * self.dtype.itemsize
            self._h = lib.i3dr_ring_create(self.name.encode(), slots, nbytes)
        else:
            self._h = lib.i3dr_ring_open(self.name.encode())
            self.frame_shape = frame_shape
        if not self._h:
            raise OSError(f"failed to map shm ring {self.name}")
        self.frame_bytes = lib.i3dr_ring_frame_bytes(self._h)

    # -- producer -------------------------------------------------------------
    def push(self, stamp: float, frame: np.ndarray, seq: int = 0) -> bool:
        buf = np.ascontiguousarray(frame, dtype=self.dtype)
        assert buf.nbytes <= self.frame_bytes, (buf.nbytes, self.frame_bytes)
        return bool(self._lib.i3dr_ring_push(
            self._h, float(stamp), seq,
            buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes))

    # -- consumer -------------------------------------------------------------
    def pop(self) -> Optional[Tuple[float, int, np.ndarray]]:
        out = np.empty(self.frame_shape, dtype=self.dtype)
        stamp = ctypes.c_double()
        seq = ctypes.c_uint64()
        ok = self._lib.i3dr_ring_pop(self._h, ctypes.byref(stamp),
                                     ctypes.byref(seq),
                                     out.ctypes.data_as(ctypes.c_void_p),
                                     out.nbytes)
        if not ok:
            return None
        return stamp.value, seq.value, out

    def peek_stamp(self) -> Optional[float]:
        stamp = ctypes.c_double()
        if self._lib.i3dr_ring_peek_stamp(self._h, ctypes.byref(stamp)):
            return stamp.value
        return None

    def __len__(self) -> int:
        return self._lib.i3dr_ring_size(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.i3dr_ring_close(self._h)
            self._h = None

    def unlink(self) -> None:
        self._lib.i3dr_ring_unlink(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        self.unlink()


def pair_pop(left: FrameRing, right: FrameRing, slop: float = 0.05
             ) -> Optional[Tuple[float, int, np.ndarray, np.ndarray]]:
    """Pop the next time-paired (left, right) frame pair, dropping stale
    frames — the native two-stream ApproximateTime policy."""
    lib = _load()
    lbuf = np.empty(left.frame_shape, dtype=left.dtype)
    rbuf = np.empty(right.frame_shape, dtype=right.dtype)
    stamp = ctypes.c_double()
    seq = ctypes.c_uint64()
    ok = lib.i3dr_pair_pop(left._h, right._h, slop,
                           ctypes.byref(stamp), ctypes.byref(seq),
                           lbuf.ctypes.data_as(ctypes.c_void_p),
                           rbuf.ctypes.data_as(ctypes.c_void_p),
                           lbuf.nbytes)
    if not ok:
        return None
    return stamp.value, seq.value, lbuf, rbuf
