"""GigE Vision camera driver — no vendor SDK required.

The reference's L0 drivers wrap vendor SDKs (TIS GStreamer source,
tiscamera.py:67-84; Basler pylon_camera, stereo_capture.launch:45-84)
around cameras that all speak the same wire protocol: **GigE Vision**
over UDP (the reference even documents the GigE tuning it needs — jumbo
frames MTU 3000, README.md:67-85). This module implements that protocol
directly, so any GigE Vision camera works without an SDK:

- **GVCP** (control, UDP port 3956): DISCOVERY, READREG/WRITEREG with
  acks, PACKETRESEND — used for bring-up, property control, stream
  channel programming, starting acquisition, and loss recovery.
- **GVSP** (streaming): LEADER / PAYLOAD / TRAILER packets carrying one
  image block, reassembled by (block_id, packet_id). Missing packets
  trigger GVCP PACKETRESEND requests (bounded retry rounds); frames
  that still cannot be completed are dropped whole (the reference
  likewise drops bad frames and continues,
  generate_disparity.cpp:679-684).

The full hardware bring-up sequence (GigE Vision 1.2 §"Device
discovery and control"):

1. DISCOVERY → identity.
2. Take the control channel: write CCP (bootstrap 0x0A00) = control
   access. Without this a camera ignores every other write.
3. Program the heartbeat timeout (bootstrap 0x0938, ms) and start a
   keepalive thread — a controlled GEV device closes the control
   channel if it hears nothing for the heartbeat period (~3 s default),
   which is exactly the failure the reference's SDKs paper over.
4. Negotiate the stream packet size: write the desired SCPS (0x0D04),
   read back what the device accepted (the reference's MTU-3000 jumbo
   guidance, README.md:67-85, maps to SCPS ≈ 2996).
5. Point the stream at the receiver: SCDA (0x0D18) = our IP,
   SCP (0x0D00) = our bound UDP port. Without these the camera has
   nowhere to send GVSP packets.
6. Geometry + properties, then acquisition start.

Only the GEV 1.x subset needed to drive a camera is implemented; the
wire formats below cite the GigE Vision 1.2 specification layouts.
Tested against an in-process loopback emulator with packet-loss /
reorder injection and heartbeat enforcement (tests/test_gige.py).
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from i3dr_stereo_tpu_torch.pipeline.pairing import Stamped

GVCP_PORT = 3956
_GVCP_MAGIC = 0x42

# GVCP command ids (GigE Vision 1.2, Table "Command values")
DISCOVERY_CMD = 0x0002
DISCOVERY_ACK = 0x0003
PACKETRESEND_CMD = 0x0040      # no ack (fire-and-forget recovery request)
READREG_CMD = 0x0080
READREG_ACK = 0x0081
WRITEREG_CMD = 0x0082
WRITEREG_ACK = 0x0083

GEV_STATUS_ACCESS_DENIED = 0x8006

# GEV bootstrap register addresses (GigE Vision 1.2 bootstrap map)
REG_HEARTBEAT_TIMEOUT = 0x0938   # ms
REG_CCP = 0x0A00                 # Control Channel Privilege
REG_SCP = 0x0D00                 # stream ch. 0 host port (low 16 bits)
REG_SCPS = 0x0D04                # stream ch. 0 packet size (low 16 bits)
REG_SCDA = 0x0D18                # stream ch. 0 destination IPv4

CCP_CONTROL = 0x2                # control-access bit

# device-specific registers (by XML in real cameras; emulator honors)
REG_ACQUISITION_START = 0x000130F4
REG_WIDTH = 0x00030204
REG_HEIGHT = 0x00030224
REG_EXPOSURE = 0x00040004
REG_GAIN = 0x00040008

# GVSP packet formats (high byte of the packet_format/packet_id word)
_FMT_LEADER = 1
_FMT_TRAILER = 2
_FMT_PAYLOAD = 3


class GVCPClient:
    """Minimal GVCP control client (one camera). Thread-safe: the
    heartbeat thread, resend requests and property writes share the
    control socket under one lock."""

    def __init__(self, address: Tuple[str, int], timeout: float = 1.0):
        self.address = address
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.settimeout(timeout)
        self._req_id = 0
        self._lock = threading.Lock()

    def _next_id(self) -> int:
        self._req_id = self._req_id % 0xFFFF + 1  # 0 is reserved
        return self._req_id

    def _cmd(self, command: int, payload: bytes) -> bytes:
        with self._lock:
            req = self._next_id()
            # GVCP CMD header: magic, flags(ack required), command, length,
            # req_id
            hdr = struct.pack(">BBHHH", _GVCP_MAGIC, 0x01, command,
                              len(payload), req)
            self.sock.sendto(hdr + payload, self.address)
            while True:
                data, _ = self.sock.recvfrom(2048)
                status, answer, length, ack_id = struct.unpack(
                    ">HHHH", data[:8])
                if ack_id != req:
                    continue  # stale ack from a timed-out earlier command
                if status != 0:
                    raise IOError(
                        f"GVCP error status={status:#x} ack_id={ack_id}")
                return data[8:8 + length]

    def discover(self) -> Dict[str, str]:
        """DISCOVERY: returns identity strings from the ack payload."""
        body = self._cmd(DISCOVERY_CMD, b"")
        # ack payload: spec version(4) ... manufacturer@80..112,
        # model@112..144, serial@224..240 (zero-padded ASCII)
        def _s(a, b):
            return body[a:b].split(b"\0")[0].decode("ascii", "replace")
        return {"manufacturer": _s(80, 112), "model": _s(112, 144),
                "serial": _s(224, 240)}

    def read_reg(self, addr: int) -> int:
        body = self._cmd(READREG_CMD, struct.pack(">I", addr))
        return struct.unpack(">I", body[:4])[0]

    def write_reg(self, addr: int, value: int) -> None:
        self._cmd(WRITEREG_CMD, struct.pack(">II", addr, value))

    def packet_resend(self, block_id: int, first_id: int, last_id: int,
                      channel: int = 0) -> None:
        """GVCP PACKETRESEND (GEV 1.2 §"Packet resend"): ask the device
        to retransmit GVSP packets [first_id, last_id] of ``block_id``
        on stream channel ``channel``. No ack is defined — recovery is
        observed on the stream socket."""
        with self._lock:
            req = self._next_id()
            hdr = struct.pack(">BBHHH", _GVCP_MAGIC, 0x00, PACKETRESEND_CMD,
                              12, req)
            payload = struct.pack(">HHII", channel, block_id & 0xFFFF,
                                  first_id & 0xFFFFFF, last_id & 0xFFFFFF)
            self.sock.sendto(hdr + payload, self.address)

    def close(self) -> None:
        self.sock.close()

    def local_ip_towards_camera(self) -> str:
        """The local interface address a stream destined for us should
        use (SCDA): the source IP of a UDP socket 'connected' to the
        camera — no packet is sent."""
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(self.address)
            return probe.getsockname()[0]
        finally:
            probe.close()


@dataclasses.dataclass
class _Block:
    leader: Optional[dict] = None
    payload: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    trailer_id: Optional[int] = None
    payload_size: int = 0            # size of a full payload packet
    resend_rounds: int = 0
    created: float = 0.0             # monotonic
    last_request: float = 0.0
    last_update: float = 0.0         # monotonic time of last packet


class GVSPReceiver:
    """Reassembles GVSP image blocks from a UDP stream socket, with
    PACKETRESEND recovery and stale-block eviction.

    ``resend`` (when provided — normally ``GVCPClient.packet_resend``)
    is called with (block_id, first_id, last_id) for each missing run
    when a block is detected incomplete; up to ``max_resend_rounds``
    rounds are attempted (re-triggered on receive-timeout ticks) before
    the frame is dropped whole (drop-and-continue). Blocks whose
    trailer never arrives are aged out after ``block_ttl`` seconds, so
    a lossy link cannot grow ``_blocks`` without bound.

    ``stats`` counts frames / dropped / packets / resend_requests /
    recovered (frames completed only thanks to resends).
    """

    def __init__(self, bind: Tuple[str, int] = ("0.0.0.0", 0),
                 timeout: float = 1.0, recv_buf: int = 4 << 20,
                 resend: Optional[Callable[[int, int, int], None]] = None,
                 max_resend_rounds: int = 4, block_ttl: float = 2.0,
                 on_timeout: str = "stop"):
        assert on_timeout in ("stop", "continue")
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, recv_buf)
        except OSError:  # pragma: no cover - platform limits
            pass
        self.sock.bind(bind)
        self.sock.settimeout(timeout if on_timeout == "stop"
                             else min(timeout, 0.05))
        self.port = self.sock.getsockname()[1]
        self.resend = resend
        self.max_resend_rounds = max_resend_rounds
        self.block_ttl = block_ttl
        self.on_timeout = on_timeout
        self.timeout = timeout
        self.stats = {"frames": 0, "dropped": 0, "packets": 0,
                      "resend_requests": 0, "recovered": 0}
        self._blocks: Dict[int, _Block] = {}
        self._closed = False
        # service incomplete blocks from the RECEIVE path too: on a
        # continuously busy lossy stream the socket never times out, so
        # timeout-tick-only servicing would let trailer-less blocks
        # accumulate forever (advisor round-4 finding)
        self._service_interval = min(self.timeout, 0.05)
        self._last_service = time.monotonic()

    def _parse(self, data: bytes):
        # GVSP GEV 1.x header: status(2), block_id(2), fmt+packet_id(4)
        status, block_id, word = struct.unpack(">HHI", data[:8])
        fmt = word >> 24
        packet_id = word & 0xFFFFFF
        return status, block_id, fmt, packet_id, data[8:]

    # -- missing-packet bookkeeping ------------------------------------

    def _expected_last(self, blk: _Block) -> Optional[int]:
        """Expected TRAILER packet id, from the leader geometry and the
        observed full-payload size (lets us re-request a lost trailer)."""
        if blk.trailer_id is not None:
            return blk.trailer_id
        if blk.leader is None or blk.payload_size == 0:
            return None
        H, W = blk.leader["height"], blk.leader["width"]
        depth = blk.leader["pixel_format"] >> 16 & 0xFF
        need = H * W * (2 if depth > 8 else 1)
        n_payload = -(-need // blk.payload_size)
        return n_payload + 1

    def _missing_runs(self, blk: _Block) -> Optional[List[Tuple[int, int]]]:
        last = self._expected_last(blk)
        if last is None:
            if blk.leader is None and blk.payload:
                return [(0, 0)]  # leader lost; geometry unknown — ask for it
            return None
        missing = ([] if blk.leader is not None else [0]) + \
            [p for p in range(1, last) if p not in blk.payload]
        if blk.trailer_id is None:
            missing.append(last)
        runs: List[Tuple[int, int]] = []
        for p in missing:
            if runs and runs[-1][1] == p - 1:
                runs[-1] = (runs[-1][0], p)
            else:
                runs.append((p, p))
        return runs

    def _request_missing(self, bid: int, blk: _Block, now: float) -> bool:
        """Issue PACKETRESEND for every missing run. Returns False when
        the retry budget is exhausted (caller should drop)."""
        if self.resend is None or blk.resend_rounds >= self.max_resend_rounds:
            return False
        runs = self._missing_runs(blk)
        if not runs:
            return runs is not None
        for first, last in runs:
            self.resend(bid, first, last)
            self.stats["resend_requests"] += 1
        blk.resend_rounds += 1
        blk.last_request = now
        return True

    def _try_finish(self, bid: int, blk: _Block) -> Optional[Stamped]:
        if blk.trailer_id is None or blk.leader is None:
            return None  # still recoverable (leader resend = packet 0)
        n_payload = blk.trailer_id - 1
        if not all(p in blk.payload for p in range(1, n_payload + 1)):
            return None
        frame = self._assemble(bid, blk)
        self.received = blk.created     # the host time of its 1st packet
        del self._blocks[bid]
        if frame is not None:
            self.stats["frames"] += 1
            if blk.resend_rounds:
                self.stats["recovered"] += 1
        else:
            self.stats["dropped"] += 1
        return frame

    def _service_pending(self, now: float, min_idle: float = 0.0) -> None:
        """Re-request or evict incomplete blocks. Called on quiet
        receive-timeout ticks (min_idle=0: the link is silent, every
        block is stalled) AND periodically from the receive path with
        ``min_idle`` set, so a continuously busy lossy stream still
        bounds memory: blocks actively receiving packets are left
        alone; stalled ones either complete via resend, exhaust their
        budget, or age out at ``block_ttl``."""
        self._last_service = now
        for bid in list(self._blocks):
            blk = self._blocks[bid]
            if now - blk.created > self.block_ttl:
                del self._blocks[bid]
                self.stats["dropped"] += 1
            elif now - blk.last_update < min_idle:
                continue  # in-flight: don't resend for packets still arriving
            elif not self._request_missing(bid, blk, now):
                del self._blocks[bid]
                self.stats["dropped"] += 1

    def frames(self) -> Iterator[Stamped]:
        """Yield complete frames as Stamped uint8/uint16 images.

        With ``on_timeout='stop'`` (bring-up / tests) the iterator
        returns at the first quiet period of ``timeout`` seconds. With
        ``'continue'`` it runs until :meth:`close` — the long-running
        capture-loop mode — servicing resend retries on idle ticks.
        """
        while not self._closed:
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                self._service_pending(time.monotonic())
                if self.on_timeout == "stop" and not self._blocks:
                    # quiet link, no recovery in flight: end of stream.
                    # (Pending blocks with resend budget get extra grace
                    # windows — at most max_resend_rounds quiet ticks.)
                    return
                continue
            except OSError:
                return  # socket closed under us
            last_rx = time.monotonic()
            self.stats["packets"] += 1
            status, bid, fmt, pid, body = self._parse(data)
            blk = self._blocks.get(bid)
            if blk is None:
                blk = self._blocks[bid] = _Block(created=last_rx)
            blk.last_update = last_rx
            if fmt == _FMT_LEADER:
                # leader payload: reserved(2), payload_type(2),
                # timestamp(8), pixel_format(4), size_x(4), size_y(4),
                # offsets/padding(16)
                (_, ptype, ts, pixfmt, sx, sy) = struct.unpack(
                    ">HHQIII", body[:24])
                blk.leader = {"timestamp": ts, "pixel_format": pixfmt,
                              "width": sx, "height": sy}
            elif fmt == _FMT_PAYLOAD:
                blk.payload[pid] = body
                blk.payload_size = max(blk.payload_size, len(body))
            elif fmt == _FMT_TRAILER:
                blk.trailer_id = pid
            frame = self._try_finish(bid, blk)
            if frame is not None:
                yield frame
            elif fmt == _FMT_TRAILER and bid in self._blocks:
                # incomplete at trailer: recover or drop NOW
                if not self._request_missing(bid, blk, last_rx):
                    del self._blocks[bid]
                    self.stats["dropped"] += 1
            if last_rx - self._last_service > self._service_interval:
                self._service_pending(last_rx,
                                      min_idle=self._service_interval)

    def _assemble(self, bid: int, blk: _Block) -> Optional[Stamped]:
        if blk.leader is None or blk.trailer_id is None:
            return None
        n_payload = blk.trailer_id - 1
        if not all(p in blk.payload for p in range(1, n_payload + 1)):
            return None  # missing packets: drop the whole frame
        raw = b"".join(blk.payload[i] for i in range(1, n_payload + 1))
        H, W = blk.leader["height"], blk.leader["width"]
        depth = blk.leader["pixel_format"] >> 16 & 0xFF  # bits per pixel
        dtype = np.uint16 if depth > 8 else np.uint8
        need = H * W * dtype().itemsize
        if len(raw) < need:
            return None
        img = np.frombuffer(raw[:need], dtype=dtype).reshape(H, W)
        # GEV timestamps are device ticks; expose seconds on a 1 GHz base
        return Stamped(blk.leader["timestamp"] / 1e9, img, seq=bid)

    def close(self) -> None:
        self._closed = True
        self.sock.close()


class GigECameraSource:
    """One GigE Vision camera as a :class:`~.sources.CameraSource`.

    Bring-up mirrors tiscamera_ctrl.py:39-53 but over the raw protocol
    (module docstring, steps 1-6): discovery, CCP control acquisition,
    heartbeat keepalive, SCPS packet-size negotiation, SCDA/SCP stream
    destination, geometry, acquisition start, then GVSP streaming with
    PACKETRESEND recovery.

    A daemon heartbeat thread reads CCP at ``heartbeat_ms / 4``; if the
    control channel is lost (camera power-cycle, network stall past the
    heartbeat window) it re-acquires control and restarts acquisition —
    the ConnectRetry behavior of the reference's camera nodes
    (tiscamera_ctrl.py retry loop) applied at the protocol layer.
    """

    PROPERTY_REGS = {"Exposure": REG_EXPOSURE, "Gain": REG_GAIN}

    def __init__(self, address: Tuple[str, int], *, width: int = 2448,
                 height: int = 2048, fps: float = 5.0,
                 stream_bind: Tuple[str, int] = ("0.0.0.0", 0),
                 timeout: float = 1.0, packet_size: int = 2996,
                 heartbeat_ms: int = 3000, on_timeout: str = "stop",
                 backend: str = "python"):
        self.ctrl = GVCPClient(address, timeout=timeout)
        self.identity = self.ctrl.discover()
        self.width, self.height, self.fps = width, height, fps
        self.heartbeat_ms = heartbeat_ms
        self.control_lost_events = 0
        # 2. take the control channel (every later write needs it)
        self.ctrl.write_reg(REG_CCP, CCP_CONTROL)
        # 3. heartbeat window, before anything slow can starve it
        self.ctrl.write_reg(REG_HEARTBEAT_TIMEOUT, heartbeat_ms)
        # 4. packet size negotiation: ask, then accept what it took
        self.ctrl.write_reg(REG_SCPS, packet_size)
        self.packet_size = self.ctrl.read_reg(REG_SCPS) & 0xFFFF
        # 5. stream destination: our IP + bound port. backend="native"
        # runs the per-packet hot loop in C++ (native/gvsp_rx.cpp) —
        # required to hold the 2x 5MP x 5FPS operating point (~34k
        # pkts/s total; pure Python tops out ~2/3 of it); "auto" uses
        # native when the toolchain can build it. The Python receiver
        # remains the reference implementation.
        if backend == "auto":
            from i3dr_stereo_tpu_torch.native.gvsp import native_available

            backend = "native" if native_available() else "python"
        self.backend = backend
        if backend == "native":
            from i3dr_stereo_tpu_torch.native.gvsp import NativeGVSPReceiver

            self.receiver = NativeGVSPReceiver(
                stream_bind, timeout=timeout,
                resend=self.ctrl.packet_resend, on_timeout=on_timeout,
                max_frame_bytes=width * height * 2)
        else:
            self.receiver = GVSPReceiver(stream_bind, timeout=timeout,
                                         resend=self.ctrl.packet_resend,
                                         on_timeout=on_timeout)
        ip = self.ctrl.local_ip_towards_camera()
        self.ctrl.write_reg(REG_SCDA,
                            struct.unpack(">I", socket.inet_aton(ip))[0])
        self.ctrl.write_reg(REG_SCP, self.receiver.port)
        # 6. geometry + go
        self.ctrl.write_reg(REG_WIDTH, width)
        self.ctrl.write_reg(REG_HEIGHT, height)
        self.ctrl.write_reg(REG_ACQUISITION_START, 1)
        self._stop_hb = threading.Event()
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._hb_thread.start()

    def _heartbeat_loop(self) -> None:
        period = self.heartbeat_ms / 1000.0 / 4.0
        while not self._stop_hb.wait(period):
            try:
                ccp = self.ctrl.read_reg(REG_CCP)
                if ccp & CCP_CONTROL:
                    continue
                # somebody (or a timeout) released us: recover
                self.control_lost_events += 1
                self._reacquire()
            except (IOError, OSError):
                # control channel unreachable; try to recover next tick
                self.control_lost_events += 1
                try:
                    self._reacquire()
                except (IOError, OSError):  # pragma: no cover - flaky net
                    pass

    def _reacquire(self) -> None:
        """Retake control and restart the stream after a heartbeat
        expiry or camera reset (stream programming is volatile state)."""
        self.ctrl.write_reg(REG_CCP, CCP_CONTROL)
        self.ctrl.write_reg(REG_HEARTBEAT_TIMEOUT, self.heartbeat_ms)
        self.ctrl.write_reg(REG_SCPS, self.packet_size)
        ip = self.ctrl.local_ip_towards_camera()
        self.ctrl.write_reg(REG_SCDA,
                            struct.unpack(">I", socket.inet_aton(ip))[0])
        self.ctrl.write_reg(REG_SCP, self.receiver.port)
        self.ctrl.write_reg(REG_WIDTH, self.width)
        self.ctrl.write_reg(REG_HEIGHT, self.height)
        self.ctrl.write_reg(REG_ACQUISITION_START, 1)

    def set_property(self, name: str, value) -> bool:
        reg = self.PROPERTY_REGS.get(name)
        if reg is None:
            return False
        self.ctrl.write_reg(reg, int(value))
        return True

    def frames(self) -> Iterator[Stamped]:
        return self.receiver.frames()

    def close(self) -> None:
        self._stop_hb.set()
        self._hb_thread.join(timeout=2)
        try:
            self.ctrl.write_reg(REG_CCP, 0)  # release control
        except (IOError, OSError):  # pragma: no cover
            pass
        self.ctrl.close()
        self.receiver.close()


# --------------------------------------------------------------------------
# loopback emulator (tests / bring-up without hardware)
# --------------------------------------------------------------------------


class GigECameraEmulator:
    """In-process GVCP responder + GVSP sender on loopback sockets.

    Emulates the protocol subset above — including CCP access control
    with heartbeat expiry, SCPS clamping to an emulated MTU, stream
    destination registers, PACKETRESEND from a sent-packet cache, and
    injectable packet loss / reordering — so the driver's recovery
    paths can be validated end-to-end without hardware.

    Access-control model (GEV 1.2): DISCOVERY and READREG are always
    allowed; WRITEREG to anything but CCP requires holding control and
    is refused with GEV_STATUS_ACCESS_DENIED otherwise. Any GVCP
    message from the controller refreshes the heartbeat; if nothing is
    heard within the programmed window the control channel is released
    and acquisition stops (what a real camera does ~3 s after its
    controller dies).
    """

    def __init__(self, serial: str = "EMU0001", *, max_packet: int = 9000,
                 enforce_control: bool = False, loss_rate: float = 0.0,
                 reorder: bool = False, resend_lossy: bool = True,
                 resend_cache_blocks: int = 64, seed: int = 0):
        self.serial = serial
        self.max_packet = max_packet
        self.enforce_control = enforce_control
        self.loss_rate = loss_rate
        self.reorder = reorder
        self.resend_lossy = resend_lossy
        self.resend_cache_blocks = resend_cache_blocks
        self._rng = np.random.default_rng(seed)
        self.regs: Dict[int, int] = {REG_WIDTH: 0, REG_HEIGHT: 0,
                                     REG_EXPOSURE: 6000, REG_GAIN: 0,
                                     REG_ACQUISITION_START: 0,
                                     REG_CCP: 0,
                                     REG_HEARTBEAT_TIMEOUT: 3000,
                                     REG_SCPS: 1500, REG_SCDA: 0,
                                     REG_SCP: 0}
        self.events: List[str] = []
        self._controller: Optional[Tuple[str, int]] = None
        self._last_ctrl = 0.0
        self._sent_cache: Dict[int, Dict[int, bytes]] = {}
        self._cache_order: List[int] = []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.05)
        self.address = self.sock.getsockname()
        self._out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- GVCP service ---------------------------------------------------

    def _check_heartbeat(self) -> None:
        if self._controller is None:
            return
        window = self.regs[REG_HEARTBEAT_TIMEOUT] / 1000.0
        if time.monotonic() - self._last_ctrl > window:
            self._controller = None
            self.regs[REG_CCP] = 0
            self.regs[REG_ACQUISITION_START] = 0
            self.events.append("heartbeat_expired")

    def _serve(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                self._check_heartbeat()
            try:
                data, peer = self.sock.recvfrom(2048)
            except socket.timeout:
                continue
            if len(data) < 8:
                continue
            magic, flags, cmd, length, req = struct.unpack(">BBHHH", data[:8])
            if magic != _GVCP_MAGIC:
                continue
            body = data[8:8 + length]
            with self._lock:
                if peer == self._controller:
                    self._last_ctrl = time.monotonic()
                if cmd == DISCOVERY_CMD:
                    payload = bytearray(248)
                    payload[80:80 + 8] = b"i3dr-emu"
                    payload[112:112 + 7] = b"virtual"
                    payload[224:224 + len(self.serial)] = \
                        self.serial.encode()
                    ack = struct.pack(">HHHH", 0, DISCOVERY_ACK,
                                      len(payload), req)
                    self.sock.sendto(ack + bytes(payload), peer)
                elif cmd == READREG_CMD:
                    addr = struct.unpack(">I", body[:4])[0]
                    val = self.regs.get(addr, 0)
                    ack = struct.pack(">HHHH", 0, READREG_ACK, 4, req)
                    self.sock.sendto(ack + struct.pack(">I", val), peer)
                elif cmd == WRITEREG_CMD:
                    addr, val = struct.unpack(">II", body[:8])
                    status = 0
                    if addr == REG_CCP:
                        if val & CCP_CONTROL:
                            self._controller = peer
                            self._last_ctrl = time.monotonic()
                        elif peer == self._controller:
                            self._controller = None
                        self.regs[REG_CCP] = val & 0x3
                    elif self.enforce_control and peer != self._controller:
                        status = GEV_STATUS_ACCESS_DENIED
                    else:
                        if addr == REG_SCPS:
                            val = min(val & 0xFFFF, self.max_packet)
                        self.regs[addr] = val
                    ack = struct.pack(">HHHH", status, WRITEREG_ACK, 4, req)
                    self.sock.sendto(ack + struct.pack(">I", 1), peer)
                elif cmd == PACKETRESEND_CMD:
                    chan, bid, first, last = struct.unpack(">HHII", body[:12])
                    self._resend(bid, first, last)

    # -- GVSP streaming -------------------------------------------------

    def stream_dest(self) -> Tuple[str, int]:
        """Destination programmed over GVCP (SCDA + SCP)."""
        ip = socket.inet_ntoa(struct.pack(">I", self.regs[REG_SCDA]))
        return (ip, self.regs[REG_SCP])

    def _send_raw(self, packet: bytes, dest: Tuple[str, int],
                  lossy: bool) -> None:
        if lossy and self.loss_rate > 0 and \
                self._rng.random() < self.loss_rate:
            return
        self._out.sendto(packet, dest)

    def _cache(self, block_id: int, pid: int, packet: bytes) -> None:
        if block_id not in self._sent_cache:
            self._sent_cache[block_id] = {}
            self._cache_order.append(block_id)
            while len(self._cache_order) > self.resend_cache_blocks:
                del self._sent_cache[self._cache_order.pop(0)]
        self._sent_cache[block_id][pid] = packet

    def _resend(self, block_id: int, first: int, last: int) -> None:
        cache = self._sent_cache.get(block_id)
        if cache is None:
            return
        dest = self.stream_dest()
        for pid in range(first, last + 1):
            pkt = cache.get(pid)
            if pkt is not None:
                self._send_raw(pkt, dest, self.resend_lossy)

    def send_frame(self, img: np.ndarray, dest: Optional[Tuple[str, int]]
                   = None, block_id: int = 1, *, timestamp_ns: int = 0,
                   payload_size: Optional[int] = None,
                   drop_packet: Optional[int] = None) -> None:
        """Stream one image as LEADER + PAYLOADs + TRAILER.

        ``dest=None`` sends to the GVCP-programmed SCDA/SCP destination
        (the hardware path); an explicit tuple overrides (legacy tests).
        ``payload_size=None`` uses the negotiated SCPS minus the GVSP
        header. Loss/reorder injection from the constructor applies;
        all sent packets enter the resend cache.
        """
        H, W = img.shape
        depth = img.dtype.itemsize * 8
        pixfmt = depth << 16
        if dest is None:
            dest = self.stream_dest()
        if payload_size is None:
            payload_size = max(64, (self.regs[REG_SCPS] & 0xFFFF) - 8)

        def pkt(fmt, pid, body=b""):
            word = (fmt << 24) | (pid & 0xFFFFFF)
            return struct.pack(">HHI", 0, block_id & 0xFFFF, word) + body

        packets: List[Tuple[int, bytes]] = []
        leader = struct.pack(">HHQIII", 0, 1, timestamp_ns, pixfmt, W, H)
        packets.append((0, pkt(_FMT_LEADER, 0, leader + b"\0" * 16)))
        raw = img.tobytes()
        pid = 1
        for off in range(0, len(raw), payload_size):
            packets.append(
                (pid, pkt(_FMT_PAYLOAD, pid, raw[off:off + payload_size])))
            pid += 1
        packets.append((pid, pkt(_FMT_TRAILER, pid)))
        for p, data in packets:
            self._cache(block_id, p, data)
        order = list(range(len(packets)))
        if self.reorder and len(order) > 3:
            # swap adjacent payload pairs pseudo-randomly (link-local
            # reordering; leaders/trailers move too — receivers must not
            # assume arrival order)
            for i in range(1, len(order) - 2, 2):
                if self._rng.random() < 0.5:
                    order[i], order[i + 1] = order[i + 1], order[i]
        for i in order:
            p, data = packets[i]
            if drop_packet is not None and p == drop_packet:
                continue
            # loss injection applies uniformly: leaders/trailers drop too
            self._send_raw(data, dest, lossy=True)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.sock.close()
        self._out.close()


@dataclasses.dataclass
class HostStamped(Stamped):
    """A frame stamped on the host's monotonic clock as its block began
    to arrive (``stamp``), with the camera's own stamp beside it
    (``device_stamp``: GEV ticks read on a 1 GHz base)."""

    device_stamp: float = 0.0


class GigEStereoSource:
    """Two GigE Vision cameras as ONE stereo source for the capture
    graph — the reference's two-tiscamera capture launch
    (launch/stereo_capture.launch:14-23) collapsed into a `.pairs()`
    provider any :func:`~i3dr_stereo_tpu_torch.bridge.launch.launch_capture`
    graph accepts.

    Each camera streams through its own :class:`GigECameraSource`
    (full bring-up: CCP, heartbeat, SCPS, PACKETRESEND; Python or
    native reassembly via ``backend``); frames are paired by timestamp
    within ``pair_tolerance_s`` — the hardware-triggered rig's frames
    carry near-equal stamps, and unmatched older frames are dropped
    (drop-and-continue, like the reference's ApproximateTime sync).
    """

    def __init__(self, left_address: Tuple[str, int],
                 right_address: Tuple[str, int], *, width: int = 2448,
                 height: int = 2048, fps: float = 5.0,
                 packet_size: int = 2996, timeout: float = 1.0,
                 backend: str = "python", on_timeout: str = "stop",
                 pair_tolerance_s: float = 0.02):
        self.left = GigECameraSource(left_address, width=width,
                                     height=height, fps=fps,
                                     packet_size=packet_size,
                                     timeout=timeout, backend=backend,
                                     on_timeout=on_timeout)
        try:
            self.right = GigECameraSource(right_address, width=width,
                                          height=height, fps=fps,
                                          packet_size=packet_size,
                                          timeout=timeout, backend=backend,
                                          on_timeout=on_timeout)
        except Exception:
            # never leak a brought-up, streaming left camera (control
            # held + heartbeat thread) when the right one fails
            self.left.close()
            raise
        self.tol = pair_tolerance_s
        self.dropped_unpaired = 0
        self._stop = threading.Event()

    def pairs(self) -> Iterator[Tuple[Stamped, Stamped]]:
        """Yield (left, right) frames matched on the host's clock. Each
        camera's blocking frame iterator runs in its own thread and
        stamps every frame with the ``time.monotonic()`` at which its
        block's first packet reached the receiver (:class:`HostStamped`):
        no backlog delays that stamp, where a block's completion, read
        once its last packet is processed, may be tens of ms late in a
        busy interpreter. The pairing loop matches those stamps within
        tolerance and drops the older frame of any unmatched pair; both
        frames of a pair carry the later of their two stamps, so
        downstream pairing sees one instant. Two cameras' GEV timestamps
        are free-running counters with no common epoch (or tick rate),
        so they are never compared: each frame keeps its own as
        ``device_stamp``. The loop returns once ``close()`` is called,
        whatever the queues hold."""
        import queue

        qs = [queue.Queue(maxsize=8), queue.Queue(maxsize=8)]

        def drain(src, q):
            # bounded put with a stop check: an abandoned pairs()
            # generator (consumer broke out / close() called) must not
            # leave this thread blocked on a full queue forever
            def put(item):
                while not self._stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
                return False

            for f in src.frames():
                if not put(HostStamped(src.receiver.received, f.data,
                                       f.seq, f.stamp)):
                    return
            put(None)                       # end-of-stream marker

        threads = [threading.Thread(target=drain, args=(s, q), daemon=True)
                   for s, q in zip((self.left, self.right), qs)]
        for t in threads:
            t.start()
        cur: list = [None, None]
        done = [False, False]
        while True:
            for i in (0, 1):
                while cur[i] is None and not done[i]:
                    if self._stop.is_set():
                        return
                    try:
                        item = qs[i].get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if item is None:
                        done[i] = True
                    else:
                        cur[i] = item
            if cur[0] is None or cur[1] is None:
                return
            dt = cur[0].stamp - cur[1].stamp
            if abs(dt) <= self.tol:
                t = max(cur[0].stamp, cur[1].stamp)
                yield (dataclasses.replace(cur[0], stamp=t),
                       dataclasses.replace(cur[1], stamp=t))
                cur = [None, None]
            elif dt < 0:                    # left older: drop it
                cur[0] = None
                self.dropped_unpaired += 1
            else:
                cur[1] = None
                self.dropped_unpaired += 1

    def set_property(self, name: str, value) -> bool:
        ok_l = self.left.set_property(name, value)
        ok_r = self.right.set_property(name, value)
        return ok_l and ok_r

    def close(self) -> None:
        self._stop.set()                    # unblock drain threads
        self.left.close()
        self.right.close()
