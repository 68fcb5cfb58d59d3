"""ctypes bindings for the native GVSP reassembly engine (gvsp_rx.cpp).

``NativeGVSPReceiver`` mirrors the Python GVSPReceiver interface
(io/gige.py) — ``port``, ``stats``, ``frames()``, ``close()`` — but the
per-packet hot path (recv, header parse, payload placement, bitmap
bookkeeping) runs in a dedicated C++ thread that never touches the GIL.
Python keeps the control plane: the ``frames()`` poll loop services
PACKETRESEND by querying the engine for missing runs and firing them
through the provided ``resend`` callable (normally
``GVCPClient.packet_resend``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from i3dr_stereo_tpu_torch.io.sources import Stamped

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gvsp_rx.cpp")
_SO = os.path.join(_DIR, "libi3dr_gvsp.so")
_lock = threading.Lock()
_lib = None


def build_native(force: bool = False) -> str:
    with _lock:
        if force or (not os.path.exists(_SO)
                     or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                   _SRC, "-o", _SO, "-pthread"]
            subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.gvsp_rx_create.restype = ctypes.c_void_p
    lib.gvsp_rx_create.argtypes = [ctypes.POINTER(ctypes.c_uint16),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_int]
    lib.gvsp_rx_poll_frame.restype = ctypes.c_int
    lib.gvsp_rx_poll_frame.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.gvsp_rx_poll_missing.restype = ctypes.c_int
    lib.gvsp_rx_poll_missing.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
    lib.gvsp_rx_port.restype = ctypes.c_uint16
    lib.gvsp_rx_port.argtypes = [ctypes.c_void_p]
    lib.gvsp_rx_stats.restype = None
    lib.gvsp_rx_stats.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint64)]
    lib.gvsp_rx_last_rx.restype = ctypes.c_double
    lib.gvsp_rx_last_rx.argtypes = [ctypes.c_void_p]
    lib.gvsp_rx_popped_received.restype = ctypes.c_double
    lib.gvsp_rx_popped_received.argtypes = [ctypes.c_void_p]
    lib.gvsp_rx_close.restype = None
    lib.gvsp_rx_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeGVSPReceiver:
    """Drop-in GVSPReceiver backed by the C++ engine.

    Bind is always 0.0.0.0:<ephemeral> (the engine owns the socket);
    ``max_frame_bytes``/``slots`` bound memory (slots x frame buffers).
    """

    MAX_RUNS = 16

    def __init__(self, bind=("0.0.0.0", 0), timeout: float = 1.0,
                 recv_buf: int = 8 << 20,
                 resend: Optional[Callable[[int, int, int], None]] = None,
                 max_resend_rounds: int = 4, block_ttl: float = 2.0,
                 on_timeout: str = "stop",
                 max_frame_bytes: int = 2448 * 2048 * 2,
                 slots: Optional[int] = None):
        assert on_timeout in ("stop", "continue")
        self._lib = _load()
        if slots is None:
            # scale the in-flight pool to a ~64 MB budget: full-res
            # frames get ~6 slots, small (test/bring-up) frames enough
            # to absorb a fast burst while resend round-trips complete
            slots = max(4, min(64, (64 << 20) // max(max_frame_bytes, 1)))
        port = ctypes.c_uint16(0)
        self._h = self._lib.gvsp_rx_create(ctypes.byref(port), recv_buf,
                                           max_frame_bytes, slots,
                                           float(block_ttl),
                                           int(max_resend_rounds))
        if not self._h:
            raise OSError("gvsp_rx_create failed")
        # every engine call races close() from other threads (pairs()
        # drain threads vs the operator's close): serialize them so the
        # C++ object is never used after gvsp_rx_close frees it
        self._call_lock = threading.Lock()
        self.port = int(port.value)
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.resend = resend
        self.max_frame_bytes = max_frame_bytes
        self._closed = False
        self._buf = (ctypes.c_uint8 * max_frame_bytes)()
        self._service_interval = min(timeout, 0.05)

    @property
    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 7)()
        with self._call_lock:
            if self._closed:
                return {"packets": 0, "frames": 0, "dropped": 0,
                        "resend_requests": 0, "recovered": 0, "pending": 0,
                        "invalidated": 0}
            self._lib.gvsp_rx_stats(self._h, out)
        return {"packets": int(out[0]), "frames": int(out[1]),
                "dropped": int(out[2]), "resend_requests": int(out[3]),
                "recovered": int(out[4]), "pending": int(out[5]),
                "invalidated": int(out[6])}

    def _service(self) -> None:
        """Drive the engine's missing-run poll: fires PACKETRESEND for
        stalled blocks through the GVCP callback; with no resend path
        (max_runs=0) the engine drops stalled blocks immediately, like
        the Python receiver with resend=None."""
        bid = ctypes.c_uint32(0)
        runs = (ctypes.c_uint32 * (2 * self.MAX_RUNS))()
        max_runs = 0 if self.resend is None else self.MAX_RUNS
        # drain stalled blocks this tick (the engine returns one block
        # per call); the 32-call cap is a safety valve — with a larger
        # small-frame pool the tail waits for the next 50 ms tick
        for _ in range(32):
            with self._call_lock:
                if self._closed:
                    return
                n = self._lib.gvsp_rx_poll_missing(
                    self._h, self._service_interval, ctypes.byref(bid),
                    runs, max_runs)
            if n <= 0:
                return
            if self.resend is not None:
                for i in range(n):
                    self.resend(int(bid.value), int(runs[2 * i]),
                                int(runs[2 * i + 1]))

    def frames(self) -> Iterator[Stamped]:
        stamp = ctypes.c_double(0)
        seq = ctypes.c_uint64(0)
        w = ctypes.c_uint32(0)
        h = ctypes.c_uint32(0)
        bpp = ctypes.c_uint32(0)
        quiet_since = time.monotonic()
        last_service = 0.0
        while not self._closed:
            with self._call_lock:
                if self._closed:
                    return
                r = self._lib.gvsp_rx_poll_frame(
                    self._h, ctypes.byref(stamp), ctypes.byref(seq),
                    self._buf, self.max_frame_bytes, ctypes.byref(w),
                    ctypes.byref(h), ctypes.byref(bpp))
                if r == 1:  # when its first packet reached the engine
                    self.received = self._lib.gvsp_rx_popped_received(
                        self._h)
            now = time.monotonic()
            if now - last_service > self._service_interval:
                last_service = now
                self._service()
            if r == 1:
                quiet_since = now
                dtype = np.uint16 if bpp.value > 8 else np.uint8
                n = w.value * h.value * dtype().itemsize
                img = (np.frombuffer(self._buf, dtype=np.uint8, count=n)
                       .copy().view(dtype).reshape(h.value, w.value))
                yield Stamped(stamp.value, img, seq=int(seq.value))
                continue
            # no frame ready: stop on a genuinely quiet link
            with self._call_lock:
                if self._closed:
                    return
                idle = self._lib.gvsp_rx_last_rx(self._h)
            if idle >= 0:
                quiet = min(idle, now - quiet_since)
            else:
                quiet = now - quiet_since
            if self.on_timeout == "stop" and quiet > self.timeout \
                    and self.stats["pending"] == 0:
                return
            time.sleep(0.002)

    def close(self) -> None:
        with self._call_lock:
            if not self._closed:
                self._closed = True
                self._lib.gvsp_rx_close(self._h)
