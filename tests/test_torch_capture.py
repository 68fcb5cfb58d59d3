"""Torch port of the capture layer, on the CPU: the shared-memory frame ring
and the native GVSP engine (``native/``), the driver processes
(``bridge/drivers.py``) and the GigE Vision driver (``io/gige.py``) with
``cli live --gige``. The copies are pinned line for line to their
originals by ``tests/test_torch_shell_nodes.py::test_copy_matches_reference``;
these tests mirror the reference's (``tests/test_native.py``,
``test_drivers.py``, ``test_gige.py``) and, where the same input fits,
feed the same frames or the same packet stream into both packages.

Four reference faults are repaired in the port, each with a test that
fails on the reference's lines (the reference's side is run as the
witness): ``GigEStereoSource.pairs()`` pairs on the host's clock (the
time each block's first packet arrived, which both receivers record),
not on
two cameras' unrelated device clocks (``io/gige.py:819``), and returns
after ``close()`` whatever its queues hold (``:812``);
``gvsp_rx_poll_missing`` writes the run it returns when ``max_runs == 1``
(``native/gvsp_rx.cpp:338``); ``Rx::find`` drops a stray packet of a
block that has completed, where the reference gives it a new entry and,
with every entry in use, evicts a block still filling
(``native/gvsp_rx.cpp:174``).
"""

import ctypes
import io
import json
import os
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from i3dr_stereo_tpu_torch.bridge.drivers import (
    ConnectRetry,
    SerialTriggerReader,
    ShmCameraPublisher,
    SyntheticRingDriver,
)
from i3dr_stereo_tpu_torch.bridge.graph import Graph
from i3dr_stereo_tpu_torch.io.gige import (
    CCP_CONTROL,
    REG_ACQUISITION_START,
    REG_CCP,
    REG_EXPOSURE,
    REG_GAIN,
    REG_HEARTBEAT_TIMEOUT,
    REG_HEIGHT,
    REG_SCDA,
    REG_SCP,
    REG_SCPS,
    REG_WIDTH,
    GigECameraEmulator,
    GigECameraSource,
    GigEStereoSource,
    GVCPClient,
    GVSPReceiver,
)
from i3dr_stereo_tpu_torch.native.shm import FrameRing, build_native, pair_pop

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device clocks of the two cameras of the fix tests: unrelated counters
CLOCK_OFFSET_NS = 1000 * 10**9


def _ring_name(tag):
    return f"i3dr_ttest_{tag}_{os.getpid()}"


# --------------------------------------------------------------------------
# native shared-memory ring (native/shm.py, shm_ring.cpp)
# --------------------------------------------------------------------------


def test_build_native_beside_the_copy():
    so = build_native()
    assert os.path.exists(so)
    assert os.path.dirname(so) == os.path.join(_REPO, "i3dr_stereo_tpu_torch",
                                               "native")


def test_ring_roundtrip_matches_reference():
    """The same frames through the port's ring and the reference's give
    the same pops, and a ring the port creates opens in the reference's
    binding (one shared-memory layout)."""
    from i3dr_stereo_tpu.native.shm import FrameRing as RefRing

    img = np.arange(80, dtype=np.uint8).reshape(8, 10)
    pops = []
    for cls, tag in ((FrameRing, "port"), (RefRing, "ref")):
        with cls(_ring_name(tag), slots=4, frame_shape=(8, 10)) as ring:
            assert ring.push(1.5, img, seq=7)
            assert ring.push(2.5, img[::-1], seq=8)
            assert len(ring) == 2
            pops.append([ring.pop() for _ in range(3)])
    for a, b in zip(*pops):
        if a is None:
            assert b is None
            continue
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
    assert pops[0][0][:2] == (1.5, 7) and pops[0][2] is None
    np.testing.assert_array_equal(pops[0][0][2], img)
    with FrameRing(_ring_name("shared"), slots=2, frame_shape=(8, 10)) as ring:
        other = RefRing(ring.name, frame_shape=(8, 10), create=False)
        assert other.push(3.0, img, seq=9)
        stamp, seq, out = ring.pop()
        assert (stamp, seq) == (3.0, 9)
        np.testing.assert_array_equal(out, img)
        other.close()


def test_ring_full_and_order():
    with FrameRing(_ring_name("b"), slots=2, frame_shape=(4,)) as ring:
        a = np.zeros(4, np.uint8)
        assert ring.push(0.0, a)
        assert ring.push(1.0, a)
        assert not ring.push(2.0, a)  # full
        s0, _, _ = ring.pop()
        s1, _, _ = ring.pop()
        assert (s0, s1) == (0.0, 1.0)


def test_pair_pop_drops_stale_as_the_reference():
    from i3dr_stereo_tpu.native.shm import FrameRing as RefRing
    from i3dr_stereo_tpu.native.shm import pair_pop as ref_pair_pop

    got = []
    for cls, pop, tag in ((FrameRing, pair_pop, "p"),
                          (RefRing, ref_pair_pop, "r")):
        with cls(_ring_name(tag + "l"), slots=8, frame_shape=(4,)) as L, \
             cls(_ring_name(tag + "r"), slots=8, frame_shape=(4,)) as R:
            a = np.arange(4, dtype=np.uint8)
            L.push(0.00, a, 0)
            L.push(0.50, a + 1, 1)
            R.push(0.49, a + 2, 10)   # only matches the second left frame
            first = pop(L, R, slop=0.05)
            assert first is not None
            got.append((first, pop(L, R, slop=0.05)))
    (p, p_next), (r, r_next) = got
    assert p[:2] == r[:2] and p[1] == 1
    np.testing.assert_array_equal(p[2], r[2])
    np.testing.assert_array_equal(p[3], r[3])
    assert p_next is None and r_next is None


def test_cross_process_producer():
    """A separate producer process pushes through the port's binding; we
    consume — the deployment shape (driver process -> pipeline host)."""
    name = _ring_name("xproc")
    with FrameRing(name, slots=16, frame_shape=(16, 16)) as ring:
        code = textwrap.dedent(f"""
            import numpy as np
            from i3dr_stereo_tpu_torch.native.shm import FrameRing
            r = FrameRing({name!r}, frame_shape=(16, 16), create=False)
            for i in range(5):
                img = np.full((16, 16), i, np.uint8)
                assert r.push(i * 0.1, img, seq=i)
            r.close()
        """)
        subprocess.run([sys.executable, "-c", code], check=True,
                       env=dict(os.environ, PYTHONPATH=_REPO),
                       capture_output=True, timeout=60)
        got = []
        while True:
            item = ring.pop()
            if item is None:
                break
            got.append(item)
        assert len(got) == 5
        for i, (stamp, seq, img) in enumerate(got):
            assert seq == i
            assert (img == i).all()


# --------------------------------------------------------------------------
# driver processes (bridge/drivers.py)
# --------------------------------------------------------------------------


def test_connect_retry_succeeds_after_failures():
    calls = []

    def connect():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("camera not ready")
        return "cam"

    r = ConnectRetry(interval=0.01, timeout=5.0)
    assert r.run(connect) == "cam"
    assert len(calls) == 3


def test_connect_retry_times_out():
    r = ConnectRetry(interval=0.01, timeout=0.05)
    with pytest.raises(TimeoutError):
        r.run(lambda: (_ for _ in ()).throw(RuntimeError("nope")))


def test_ring_driver_to_publisher():
    with FrameRing(_ring_name("drv"), slots=16, frame_shape=(8, 8)) as ring:
        drv = SyntheticRingDriver(
            ring, lambda i: np.full((8, 8), i, np.uint8), fps=100.0)
        drv.start(n_frames=5)
        drv.stop()
        g = Graph()
        pub = ShmCameraPublisher(g, ring, "/stereo/left")
        got = []
        g.subscribe("/stereo/left/image_raw", lambda s, d: got.append((s, d)))
        n = pub.pump()
        assert n == 5
        assert got[3][1][0, 0] == 3
        assert [s for s, _ in got] == [i / 100.0 for i in range(5)]


def test_laser_split_publisher():
    with FrameRing(_ring_name("drv2"), slots=8, frame_shape=(4,)) as ring:
        g = Graph()
        pub = ShmCameraPublisher(g, ring, "/stereo/left", split_laser=True)
        routed = []
        g.subscribe("/stereo/left/image_raw_with_laser",
                    lambda s, d: routed.append("with"))
        g.subscribe("/stereo/left/image_raw_no_laser",
                    lambda s, d: routed.append("no"))
        g.publish("/phobos_nuclear_trigger", 0.0, True)
        ring.push(0.0, np.zeros(4, np.uint8))
        pub.pump()
        g.publish("/phobos_nuclear_trigger", 0.1, False)
        ring.push(0.1, np.zeros(4, np.uint8))
        pub.pump()
        assert routed == ["with", "no"]


def test_serial_trigger_parses_lines_as_the_reference():
    from i3dr_stereo_tpu.bridge.drivers import SerialTriggerReader as Ref

    stream = [b"Laser:ON\n", b"garbage\n", b"Laser:OFF\n", "Laser:ON\n"]
    events = {}
    for name, cls in (("port", SerialTriggerReader), ("ref", Ref)):
        got = events[name] = []
        reader = cls(lambda: None, lambda t, on, got=got: got.append(on))
        assert reader.run_once(iter(stream)) == 3
    assert events["port"] == events["ref"] == [True, False, True]
    # run() reopens after a failed open, then reads the stream once
    opened = []

    def open_fn():
        opened.append(1)
        if len(opened) == 1:
            raise OSError("no port")
        return io.BytesIO(b"Laser:OFF\n")

    got = []
    SerialTriggerReader(open_fn, lambda t, on: got.append(on),
                        reopen_delay=0.01).run()
    assert len(opened) == 2 and got == [False]


def test_device_mem_api():
    from i3dr_stereo_tpu_torch.utils.device_memory import DeviceMem

    m = DeviceMem("cpu")
    s = m.summary()
    assert set(s) == {"device", "total", "used", "free"}
    assert m.get_mem_used() >= 0


# --------------------------------------------------------------------------
# GigE Vision driver (io/gige.py)
# --------------------------------------------------------------------------


@pytest.fixture()
def emu():
    e = GigECameraEmulator(serial="CAM00042")
    yield e
    e.close()


def _receivers(**kw):
    from i3dr_stereo_tpu.io.gige import GVSPReceiver as Ref

    return (GVSPReceiver(("127.0.0.1", 0), **kw),
            Ref(("127.0.0.1", 0), **kw))


def test_gvcp_discovery_and_registers(emu):
    c = GVCPClient(emu.address)
    ident = c.discover()
    assert ident["serial"] == "CAM00042"
    assert ident["manufacturer"] == "i3dr-emu"
    c.write_reg(REG_EXPOSURE, 12345)
    assert c.read_reg(REG_EXPOSURE) == 12345
    assert emu.regs[REG_EXPOSURE] == 12345
    c.close()


def test_gvsp_frame_reassembly_as_the_reference(emu):
    """One packet stream into the port's receiver and the reference's."""
    rxs = _receivers(timeout=0.5)
    img = np.random.default_rng(0).integers(0, 255, (48, 64), dtype=np.uint8)
    for rx in rxs:
        emu.send_frame(img, ("127.0.0.1", rx.port), block_id=7,
                       timestamp_ns=123_000_000, payload_size=500)
    (f,), (g,) = (list(rx.frames()) for rx in rxs)
    np.testing.assert_array_equal(f.data, img)
    np.testing.assert_array_equal(f.data, g.data)
    assert (f.seq, f.stamp) == (g.seq, g.stamp) == (7, pytest.approx(0.123))
    for rx in rxs:
        assert rx.stats["frames"] == 1 and rx.stats["dropped"] == 0
        rx.close()
    assert rxs[0].stats == rxs[1].stats


def test_gvsp_drops_incomplete_frames(emu):
    """A frame with a lost payload packet is dropped whole; the next
    frame still arrives (drop-and-continue), in both packages."""
    rxs = _receivers(timeout=0.5)
    img = np.arange(48 * 64, dtype=np.uint8).reshape(48, 64) % 251
    for rx in rxs:
        emu.send_frame(img, ("127.0.0.1", rx.port), block_id=1,
                       payload_size=400, drop_packet=2)
        emu.send_frame(img, ("127.0.0.1", rx.port), block_id=2,
                       payload_size=400)
    for rx in rxs:
        frames = list(rx.frames())
        assert len(frames) == 1 and frames[0].seq == 2
        assert rx.stats["dropped"] == 1
        rx.close()


def test_gige_camera_source_end_to_end(emu):
    src = GigECameraSource(emu.address, width=64, height=48, fps=5.0)
    assert src.identity["serial"] == "CAM00042"
    assert emu.regs[REG_WIDTH] == 64 and emu.regs[REG_HEIGHT] == 48
    assert src.set_property("Gain", 7) and emu.regs[REG_GAIN] == 7
    assert not src.set_property("Bogus", 1)
    img = np.full((48, 64), 9, np.uint8)
    emu.send_frame(img, ("127.0.0.1", src.receiver.port), block_id=3)
    got = list(src.frames())
    assert len(got) == 1
    np.testing.assert_array_equal(got[0].data, img)
    src.close()


def test_gvsp_16bit_pixels_as_the_reference(emu):
    rxs = _receivers(timeout=0.5)
    img = (np.arange(32 * 40, dtype=np.uint16) * 17 % 4096).reshape(32, 40)
    for rx in rxs:
        emu.send_frame(img, ("127.0.0.1", rx.port), block_id=5,
                       payload_size=333)
    (f,), (g,) = (list(rx.frames()) for rx in rxs)
    assert f.data.dtype == g.data.dtype == np.uint16
    np.testing.assert_array_equal(f.data, img)
    np.testing.assert_array_equal(g.data, img)
    for rx in rxs:
        rx.close()


def test_bringup_programs_stream_channel():
    """Full GEV bring-up against a control-enforcing camera: CCP taken,
    SCPS negotiated (clamped to the device MTU), SCDA/SCP point at the
    receiver, and a frame sent to the programmed destination arrives."""
    emu = GigECameraEmulator(serial="HW1", enforce_control=True,
                             max_packet=1500)
    try:
        src = GigECameraSource(emu.address, width=64, height=48,
                               packet_size=2996, timeout=0.3)
        assert emu.regs[REG_CCP] & CCP_CONTROL
        assert src.packet_size == 1500          # clamped by the device
        assert emu.regs[REG_SCP] == src.receiver.port
        assert emu.regs[REG_SCDA] == struct.unpack(
            ">I", socket.inet_aton("127.0.0.1"))[0]
        assert emu.regs[REG_WIDTH] == 64 and emu.regs[REG_HEIGHT] == 48
        assert emu.regs[REG_ACQUISITION_START] == 1
        img = np.arange(48 * 64, dtype=np.uint8).reshape(48, 64) % 250
        emu.send_frame(img, block_id=11)        # dest from SCDA/SCP
        got = list(src.frames())
        assert len(got) == 1
        np.testing.assert_array_equal(got[0].data, img)
        src.close()
        assert emu.regs[REG_CCP] == 0           # control released on close
    finally:
        emu.close()


def test_writereg_denied_without_control():
    emu = GigECameraEmulator(enforce_control=True)
    try:
        c = GVCPClient(emu.address, timeout=0.5)
        with pytest.raises(IOError, match="0x8006"):
            c.write_reg(REG_EXPOSURE, 100)
        c.write_reg(REG_CCP, CCP_CONTROL)
        c.write_reg(REG_EXPOSURE, 100)
        assert emu.regs[REG_EXPOSURE] == 100
        c.close()
    finally:
        emu.close()


def test_heartbeat_keeps_session_alive():
    emu = GigECameraEmulator(enforce_control=True)
    try:
        src = GigECameraSource(emu.address, width=8, height=8,
                               heartbeat_ms=300, timeout=0.3)
        time.sleep(1.2)                          # 4x the window
        assert "heartbeat_expired" not in emu.events
        assert emu.regs[REG_ACQUISITION_START] == 1
        assert src.control_lost_events == 0
        src.close()
    finally:
        emu.close()


def _wait(cond, seconds):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_heartbeat_expiry_kills_then_driver_recovers():
    emu = GigECameraEmulator(enforce_control=True)
    try:
        c = GVCPClient(emu.address, timeout=0.5)
        c.write_reg(REG_CCP, CCP_CONTROL)
        c.write_reg(REG_HEARTBEAT_TIMEOUT, 200)
        assert _wait(lambda: "heartbeat_expired" in emu.events, 3.0)
        assert emu.regs[REG_ACQUISITION_START] == 0
        c.close()

        src = GigECameraSource(emu.address, width=8, height=8,
                               heartbeat_ms=400, timeout=0.3)
        with emu._lock:                          # a camera-side reset
            emu._controller = None
            emu.regs[REG_CCP] = 0
            emu.regs[REG_ACQUISITION_START] = 0
        assert _wait(lambda: src.control_lost_events >= 1, 3.0)
        assert _wait(lambda: emu.regs[REG_ACQUISITION_START] == 1, 2.0)
        assert emu.regs[REG_CCP] & CCP_CONTROL
        src.close()
    finally:
        emu.close()


def test_packet_resend_recovers_lossy_stream():
    """2% injected loss (payloads, leaders and trailers) with lossy
    resends too: every frame still completes via PACKETRESEND rounds."""
    emu = GigECameraEmulator(enforce_control=True, loss_rate=0.02,
                             resend_lossy=True, seed=7)
    try:
        src = GigECameraSource(emu.address, width=64, height=48,
                               packet_size=264, timeout=0.2)
        n = 50
        rng = np.random.default_rng(1)
        imgs = [rng.integers(0, 255, (48, 64), np.uint8) for _ in range(n)]
        for i, img in enumerate(imgs):
            emu.send_frame(img, block_id=i + 1)
        got = {f.seq: f for f in src.frames()}
        st = src.receiver.stats
        assert st["resend_requests"] > 0 and st["recovered"] > 0
        assert len(got) >= int(0.99 * n)
        for i, img in enumerate(imgs):
            if i + 1 in got:
                np.testing.assert_array_equal(got[i + 1].data, img)
        src.close()
    finally:
        emu.close()


def test_reordered_stream_reassembles_without_resend():
    emu = GigECameraEmulator(enforce_control=True, reorder=True, seed=3)
    try:
        src = GigECameraSource(emu.address, width=40, height=32,
                               packet_size=200, timeout=0.3)
        img = (np.arange(32 * 40, dtype=np.uint8) % 240).reshape(32, 40)
        for i in range(5):
            emu.send_frame(img, block_id=i + 1)
        got = list(src.frames())
        assert len(got) == 5
        assert src.receiver.stats["resend_requests"] == 0
        src.close()
    finally:
        emu.close()


def test_stale_blocks_age_out():
    rx = GVSPReceiver(("127.0.0.1", 0), timeout=0.2, block_ttl=0.3)
    emu = GigECameraEmulator()
    try:
        img = np.zeros((16, 16), np.uint8)
        emu.send_frame(img, ("127.0.0.1", rx.port), block_id=1,
                       payload_size=200, drop_packet=3)   # no trailer
        t0 = time.monotonic()
        assert list(rx.frames()) == []
        assert rx.stats["dropped"] == 1
        assert not rx._blocks
        assert time.monotonic() - t0 < 5.0
    finally:
        emu.close()
        rx.close()


# --------------------------------------------------------------------------
# native GVSP engine (native/gvsp_rx.cpp)
# --------------------------------------------------------------------------


def _native_ok():
    try:
        from i3dr_stereo_tpu_torch.native.gvsp import native_available

        return native_available()
    except Exception:
        return False


native = pytest.mark.skipif(not _native_ok(), reason="no g++ toolchain")


@native
def test_native_rx_roundtrip_and_16bit_as_the_reference():
    """Bit-exact reassembly through the C++ hot loop, 8- and 16-bit: one
    packet stream into the port's engine and the reference's."""
    from i3dr_stereo_tpu.native.gvsp import NativeGVSPReceiver as Ref
    from i3dr_stereo_tpu_torch.native.gvsp import NativeGVSPReceiver

    emu = GigECameraEmulator()
    try:
        rxs = [cls(timeout=0.3, max_frame_bytes=1 << 16)
               for cls in (NativeGVSPReceiver, Ref)]
        img = (np.arange(48 * 64, dtype=np.uint8) % 250).reshape(48, 64)
        img16 = (np.arange(32 * 40, dtype=np.uint16) * 17 % 4096
                 ).reshape(32, 40)
        for rx in rxs:
            for i in range(3):
                emu.send_frame(img + i, ("127.0.0.1", rx.port),
                               block_id=i + 1, payload_size=1492,
                               timestamp_ns=i * 10**8)
            emu.send_frame(img16, ("127.0.0.1", rx.port), block_id=9,
                           payload_size=352)
        got = [list(rx.frames()) for rx in rxs]
        for rx in rxs:
            rx.close()
        port, ref = got
        assert [f.seq for f in port] == [f.seq for f in ref] == [1, 2, 3, 9]
        for i, (f, g) in enumerate(zip(port, ref)):
            assert f.stamp == g.stamp and f.data.dtype == g.data.dtype
            np.testing.assert_array_equal(f.data, g.data)
            np.testing.assert_array_equal(f.data, img + i if i < 3 else img16)
    finally:
        emu.close()


@native
def test_native_rx_lossy_recovers():
    emu = GigECameraEmulator(enforce_control=True, loss_rate=0.02,
                             resend_lossy=True, seed=7)
    try:
        src = GigECameraSource(emu.address, width=64, height=48,
                               packet_size=264, timeout=0.4,
                               backend="native")
        n = 50
        rng = np.random.default_rng(1)
        imgs = [rng.integers(0, 255, (48, 64), np.uint8) for _ in range(n)]
        for i, img in enumerate(imgs):
            emu.send_frame(img, block_id=i + 1)
            time.sleep(0.002)   # resend round-trips need service ticks
        got = {f.seq: f for f in src.frames()}
        st = src.receiver.stats
        assert st["resend_requests"] > 0 and st["recovered"] > 0
        assert len(got) >= int(0.95 * n), (len(got), st)
        for i, img in enumerate(imgs):
            if i + 1 in got:
                np.testing.assert_array_equal(got[i + 1].data, img)
        src.close()
    finally:
        emu.close()


@native
def test_native_rx_reordered_stream():
    emu = GigECameraEmulator(enforce_control=True, reorder=True, seed=3)
    try:
        src = GigECameraSource(emu.address, width=40, height=32,
                               packet_size=200, timeout=0.3,
                               backend="native")
        img = (np.arange(32 * 40, dtype=np.uint8) % 240).reshape(32, 40)
        for i in range(5):
            emu.send_frame(img, block_id=i + 1)
        got = list(src.frames())
        assert len(got) == 5
        for f in got:
            np.testing.assert_array_equal(f.data, img)
        src.close()
    finally:
        emu.close()


@native
def test_native_rx_stale_blocks_age_out():
    from i3dr_stereo_tpu_torch.native.gvsp import NativeGVSPReceiver

    rx = NativeGVSPReceiver(timeout=0.2, max_frame_bytes=1 << 16)
    emu = GigECameraEmulator()
    try:
        img = np.zeros((16, 16), np.uint8)
        emu.send_frame(img, ("127.0.0.1", rx.port), block_id=1,
                       payload_size=200, drop_packet=3)   # no trailer
        t0 = time.monotonic()
        assert list(rx.frames()) == []
        st = rx.stats
        assert st["dropped"] >= 1 and st["pending"] == 0
        assert time.monotonic() - t0 < 5.0
    finally:
        emu.close()
        rx.close()


@native
def test_native_engine_keeps_the_arrival_time():
    """The engine records the host's monotonic time at which a block's
    first packet arrived (``pairs()`` pairs on it): a frame polled late
    still carries the time it arrived."""
    from i3dr_stereo_tpu_torch.native.gvsp import NativeGVSPReceiver

    rx = NativeGVSPReceiver(timeout=0.3, max_frame_bytes=1 << 16)
    emu = GigECameraEmulator()
    try:
        t0 = time.monotonic()
        emu.send_frame(np.zeros((16, 16), np.uint8), ("127.0.0.1", rx.port),
                       block_id=1, payload_size=200)
        assert _wait(lambda: rx.stats["frames"] == 1, 5.0)
        t1 = time.monotonic()
        time.sleep(0.3)
        assert len(list(rx.frames())) == 1
        assert t0 <= rx.received <= t1 < time.monotonic() - 0.3
    finally:
        emu.close()
        rx.close()


def test_python_receiver_keeps_the_arrival_time(emu):
    """The Python receiver's ``received`` is the time its block's first
    packet was read, not the time the block completed."""
    rx = GVSPReceiver(("127.0.0.1", 0), timeout=1.0)
    got = []
    t = threading.Thread(target=lambda: got.extend(
        (f, rx.received, time.monotonic()) for f in rx.frames()))
    t.start()
    t0 = time.monotonic()
    emu.send_frame(np.zeros((48, 64), np.uint8), ("127.0.0.1", rx.port),
                   block_id=1, payload_size=400, drop_packet=9)  # trailer
    time.sleep(0.3)
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    out.sendto(emu._sent_cache[1][9], ("127.0.0.1", rx.port))
    out.close()
    t.join(timeout=5)
    assert not t.is_alive()
    rx.close()
    ((f, received, yielded),) = got
    assert f.seq == 1 and t0 <= received < yielded - 0.25


@native
def test_poll_missing_with_one_run_writes_it():
    """A block seen only by a payload packet (no leader, no trailer: its
    geometry unknown) asks for its leader, run (0, 0). With room for one
    run the port writes it; the reference returns 1 and leaves the run
    unwritten (``gvsp_rx.cpp:338`` guarded on ``max_runs >= 2``)."""
    from i3dr_stereo_tpu.native.gvsp import NativeGVSPReceiver as Ref
    from i3dr_stereo_tpu_torch.native.gvsp import NativeGVSPReceiver

    sentinel = 0xDEADBEEF
    got = {}
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for name, cls in (("port", NativeGVSPReceiver), ("ref", Ref)):
            rx = cls(timeout=0.2, max_frame_bytes=1 << 16)
            out.sendto(struct.pack(">HHI", 0, 5, (3 << 24) | 1)
                       + b"\x07" * 100, ("127.0.0.1", rx.port))
            assert _wait(lambda: rx.stats["pending"] == 1, 5.0)
            bid = ctypes.c_uint32(0)
            runs = (ctypes.c_uint32 * 2)(sentinel, sentinel)
            n = rx._lib.gvsp_rx_poll_missing(rx._h, 0.0, ctypes.byref(bid),
                                             runs, 1)
            got[name] = (n, bid.value, list(runs))
            rx.close()
    finally:
        out.close()
    assert got["port"] == (1, 5, [0, 0])
    assert got["ref"] == (1, 5, [sentinel, sentinel])     # the witness


def _gvsp(block_id, fmt, pid, body=b""):
    """One GVSP packet: GEV 1.x header, then ``body``."""
    return struct.pack(">HHI", 0, block_id, (fmt << 24) | pid) + body


def _leader(block_id, w, h):
    return _gvsp(block_id, 1, 0, struct.pack(">HHQIII", 0, 1, 0, 8 << 16,
                                             w, h))


@native
def test_stray_packet_of_a_completed_block_evicts_nothing():
    """Block 1 completes; blocks 2-11 take every entry of an engine with
    two slots (ten entries) and start filling; then a duplicate payload
    of block 1 arrives, and block 2 gets its payload and trailer. The
    port drops the stray (``Rx::find``), so block 2 completes and nothing
    is dropped. The reference gives the stray a new entry, which evicts
    block 2, the oldest still filling: block 2 never completes and the
    dropped count rises (``gvsp_rx.cpp:174``)."""
    from i3dr_stereo_tpu.native.gvsp import NativeGVSPReceiver as Ref
    from i3dr_stereo_tpu_torch.native.gvsp import NativeGVSPReceiver

    w, h = 16, 4
    payload = bytes(range(w * h))
    got = {}
    out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for name, cls in (("port", NativeGVSPReceiver), ("ref", Ref)):
            rx = cls(timeout=0.2, max_frame_bytes=1 << 16, slots=2)
            dest = ("127.0.0.1", rx.port)
            sent = 0

            def send(*packets):
                nonlocal sent
                for pk in packets:
                    out.sendto(pk, dest)
                sent += len(packets)
                assert _wait(lambda: rx.stats["packets"] == sent, 5.0)

            send(_leader(1, w, h), _gvsp(1, 3, 1, payload), _gvsp(1, 2, 2))
            assert rx.stats["frames"] == 1
            send(*(_leader(b, w, h) for b in range(2, 12)))
            assert rx.stats["pending"] == 10        # every entry in use
            send(_gvsp(1, 3, 1, payload))           # the stray
            send(_gvsp(2, 3, 1, payload), _gvsp(2, 2, 2))
            st = rx.stats
            got[name] = (st["frames"], st["dropped"])
            rx.close()
    finally:
        out.close()
    assert got["port"] == (2, 0)
    frames, dropped = got["ref"]                    # the witness
    assert frames == 1 and dropped >= 1


# --------------------------------------------------------------------------
# the stereo source (GigEStereoSource.pairs) and cli live --gige
# --------------------------------------------------------------------------


def _stereo_pair_images(h=48, w=64, shift=4):
    rng = np.random.default_rng(0)
    base = rng.uniform(40, 215, (h, w + shift))
    base = 0.25 * (np.roll(base, 1, 1) + np.roll(base, -1, 1)
                   + np.roll(base, 1, 0) + np.roll(base, -1, 0))
    return base[:, :w].astype(np.uint8), base[:, shift:].astype(np.uint8)


def _emulators():
    return [GigECameraEmulator(serial=s, enforce_control=True,
                               max_packet=1500) for s in ("SL", "SR")]


def _stream(emus, left, right, n, period=0.1, first=1):
    """Trigger both cameras together ``n`` times, ``period`` apart; the
    right camera's device clock runs ``CLOCK_OFFSET_NS`` ahead."""
    for i in range(n):
        ts = int(i * period * 1e9)
        emus[0].send_frame(left, block_id=first + i, timestamp_ns=ts)
        emus[1].send_frame(right, block_id=first + i,
                           timestamp_ns=ts + CLOCK_OFFSET_NS)
        time.sleep(period)


def _pairs_across_clock_offset(cls, backend):
    emus = _emulators()
    try:
        src = cls(emus[0].address, emus[1].address, width=64, height=48,
                  timeout=0.4, backend=backend)
        left, right = _stereo_pair_images()
        t = threading.Thread(target=_stream, args=(emus, left, right, 3))
        t.start()
        got = list(src.pairs())
        t.join(timeout=10)
        assert not t.is_alive()
        src.close()
        return got, src.dropped_unpaired
    finally:
        for e in emus:
            e.close()


@pytest.mark.parametrize("backend", ["python",
                                     pytest.param("native", marks=native)])
def test_pairs_on_the_host_clock_across_device_clocks(backend):
    """Two cameras whose device clocks are 1000 s apart (free-running
    counters, as real cameras' are): the port pairs every trigger on the
    host's clock, each frame keeping its own device stamp; the
    reference, which compares the device stamps, pairs none (the
    witness)."""
    from i3dr_stereo_tpu.io.gige import GigEStereoSource as Ref

    t0 = time.monotonic()
    got, dropped = _pairs_across_clock_offset(GigEStereoSource, backend)
    assert [(l.seq, r.seq) for l, r in got] == [(1, 1), (2, 2), (3, 3)]
    assert dropped == 0
    for i, (l, r) in enumerate(got):
        assert l.device_stamp == pytest.approx(0.1 * i)
        assert r.device_stamp == pytest.approx(1000.0 + 0.1 * i)
        assert t0 < l.stamp == r.stamp < time.monotonic()
    ref_got, ref_dropped = _pairs_across_clock_offset(Ref, backend)
    assert ref_got == [] and ref_dropped == 3


def test_pairs_returns_after_close_with_a_full_queue():
    """Only the left camera streams, so its queue fills while the loop
    waits for a right frame; ``close()`` must end ``pairs()`` within a
    second. The reference's loop blocks in ``Queue.get()`` for ever (its
    drain thread gives up the end-of-stream put once stopped): the
    witness thread is still waiting a second after its ``close()``."""
    from i3dr_stereo_tpu.io.gige import GigEStereoSource as Ref

    img = np.zeros((48, 64), np.uint8)
    alive = {}
    for name, cls in (("port", GigEStereoSource), ("ref", Ref)):
        emus = _emulators()
        try:
            src = cls(emus[0].address, emus[1].address, width=64, height=48,
                      timeout=0.3, on_timeout="continue")
            for i in range(12):
                emus[0].send_frame(img, block_id=i + 1)
            got = []
            t = threading.Thread(target=lambda: got.extend(src.pairs()),
                                 daemon=True)
            t.start()
            time.sleep(0.5)
            assert t.is_alive() and not got
            src.close()
            t.join(timeout=1.0)
            alive[name] = t.is_alive()
        finally:
            for e in emus:
                e.close()
    assert alive == {"port": False, "ref": True}


def test_gige_stereo_source_drives_capture_graph():
    """Two emulated GigE cameras -> bring-up -> paired GVSP streams ->
    ``pairs()`` -> the capture graph -> the matcher on the CPU ->
    disparity; a leading unpaired left frame is dropped, not paired."""
    from i3dr_stereo_tpu_torch.bridge.launch import (launch_stereo_camera,
                                                     run_source)
    from i3dr_stereo_tpu_torch.config.params import (ALGORITHM_DEFAULTS,
                                                     Algorithm)
    from i3dr_stereo_tpu_torch.core.camera import StereoRig

    H, W, shift = 48, 64, 4
    emus = _emulators()
    try:
        src = GigEStereoSource(emus[0].address, emus[1].address, width=W,
                               height=H, timeout=0.4)
        left, right = _stereo_pair_images(H, W, shift)

        def send():
            emus[0].send_frame(left, block_id=9, timestamp_ns=int(5e7))
            time.sleep(0.1)
            _stream(emus, left, right, 3)

        t = threading.Thread(target=send)
        t.start()
        rig = StereoRig.synthetic(W, H, fx=100.0)
        cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(
            disparity_range=16, speckle_size=0)
        lg = launch_stereo_camera(rig, stereo_algorithm=Algorithm.SGBM,
                                  source=src, rectify_inputs=False,
                                  config=cfg, warmup=False, device="cpu")
        got = []
        lg.graph.subscribe("/stereo/disparity",
                           lambda s, d: got.append((s, d)))
        n = run_source(lg)
        t.join(timeout=10)
        assert not t.is_alive() and n == 3 and len(got) == 3
        assert src.dropped_unpaired == 1
        d, v = got[0][1]["disparity"], got[0][1]["valid"]
        assert v.any() and abs(float(np.median(d[v])) - shift) < 1.0
        src.close()
    finally:
        for e in emus:
            e.close()


@pytest.mark.parametrize("backend", ["python",
                                     pytest.param("native", marks=native)])
def test_cli_live_gige(backend, capsys):
    """``cli live --gige`` against two emulated cameras streaming once
    the CLI has brought them up (at the packet size it asked for); the
    CLI releases both at its end."""
    from i3dr_stereo_tpu_torch import cli
    from i3dr_stereo_tpu_torch.io.synthetic import layered_scene

    sc = layered_scene(80, 96, max_disp=12, seed=1)
    left, right = (np.clip(np.rint(x), 0, 255).astype(np.uint8)
                   for x in (sc.left, sc.right))
    emus = _emulators()

    def send():
        assert _wait(lambda: all(e.regs[REG_ACQUISITION_START] == 1
                                 and e.regs[REG_SCP] for e in emus), 30.0)
        _stream(emus, left, right, 3)

    t = threading.Thread(target=send, daemon=True)
    try:
        t.start()
        addrs = ",".join(f"{h}:{p}" for h, p in (e.address for e in emus))
        rc = cli.main(["live", "--gige", addrs, "--gige-backend", backend,
                       "--packet-size", "1200", "--width", "96", "--height",
                       "80", "--algorithm", "BM", "--device", "cpu"])
        t.join(timeout=10)
        assert not t.is_alive()
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and out == {"frames": 3, "processed": 3}
        assert all(e.regs[REG_CCP] == 0 for e in emus)
        assert emus[0].regs[REG_SCPS] == emus[1].regs[REG_SCPS] == 1200
    finally:
        for e in emus:
            e.close()
