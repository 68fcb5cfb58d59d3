"""Reading the profiler's trace and the host's syncs (copies of
``chip_smoke.py:device_spans`` / ``busy_ms`` / ``sync_sites``, with the
gap labels added).

Times are the profiler's microseconds. The harness's own spans are
``torch.profiler.record_function`` ranges named ``portbench.<what>`` on
the thread that publishes into the graph, so they share the trace's
clock."""

from __future__ import annotations

import dataclasses
import traceback
import warnings
from pathlib import Path

import torch

SPAN = "portbench."
NAME_CHARS = 160     # a device op's name in the breakdown, cut there


@dataclasses.dataclass
class Trace:
    """What one traced segment holds: ``device`` (start, end, name) of
    every device activity (kernels, copies, memsets), ``cpu`` (start,
    end, name, thread) of every host op and harness span, ``frames``
    the number of frames traced."""

    device: list
    cpu: list
    frames: int

    def spans(self, name: str) -> list:
        """(start, end) of the harness's spans ``portbench.<name>``."""
        return [(s, e) for s, e, n, _ in self.cpu if n == SPAN + name]

    @property
    def window(self) -> tuple:
        """(start, end) of the traced frames: the first frame's publish to
        the last frame's delivery."""
        fr = self.spans("frame")
        return min(s for s, _ in fr), max(e for _, e in fr)


def read(prof, frames: int) -> Trace:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN):   # the spans' device rows
                device.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            cpu.append((tr.start, tr.end, e.name, e.thread))
    device.sort()
    cpu.sort()
    t = Trace(device, cpu, frames)
    if t.spans("frame"):
        # only what ran while the window's traced frames did
        s, e = t.window
        t.device = [x for x in device if x[1] > s and x[0] < e]
    return t


def union(intervals) -> list:
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, within) -> list:
    """The parts of ``intervals`` inside the union ``within``."""
    out = []
    for s, e in intervals:
        for ws, we in within:
            a, b = max(s, ws), min(e, we)
            if a < b:
                out.append((a, b))
    return out


def busy(trace: Trace, within) -> float:
    """Microseconds in which some device activity ran, inside ``within``."""
    return length(union(clip([(s, e) for s, e, _ in trace.device], within)))


def gaps(trace: Trace, within) -> list:
    """(start, end) of the idle stretches of the device inside
    ``within``."""
    busy_u = union(clip([(s, e) for s, e, _ in trace.device], within))
    out = []
    for ws, we in within:
        t = ws
        for s, e in busy_u:
            if e <= ws or s >= we:
                continue
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < we:
            out.append((t, we))
    return out


def labels(trace: Trace, times) -> list:
    """What the host's publishing thread was doing at each of the sorted
    ``times``: the innermost harness span (``frame``, ``dispatch``,
    ``publish``, ``spinner_wait``), and below it the innermost host op.
    Host ops on one thread nest, so one sweep with a stack of the open
    ops answers every time."""
    threads = {th for _, _, n, th in trace.cpu if n == SPAN + "frame"}
    ev = sorted(((s, -e, n) for s, e, n, th in trace.cpu if th in threads))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ev) and ev[i][0] <= t:
            s, ne, n = ev[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((-ne, n))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        span = op = None
        for e, n in reversed(stack):
            if e < t:
                continue
            if n.startswith(SPAN):
                if span is None or span == "frame":
                    span = n[len(SPAN):]
                if span != "frame":
                    break
            elif op is None and span is None:
                op = n
        span = span or "outside frames"
        out.append(span if op is None else f"{span}: {op}")
    return out


def breakdown(trace: Trace, within, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing, in seconds, ``top`` of each."""
    by_op: dict = {}
    for s, e, n in trace.device:
        n = n if len(n) <= NAME_CHARS else n[:NAME_CHARS - 3] + "..."
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
    by_gap: dict = {}
    idle = gaps(trace, within)
    for (s, e), key in zip(idle, labels(trace, [0.5 * (s + e)
                                                for s, e in idle])):
        by_gap[key] = by_gap.get(key, 0.0) + (e - s) * 1e-6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(by_gap)]}


def sync_sites(fn, package: Path, inside: tuple = ()) -> dict:
    """Host syncs of one call of ``fn``, by the package's innermost source
    line that issued each (PyTorch's sync debug mode warns at every call
    that makes the host wait for the device). With ``inside`` =
    (file name, function), only the syncs under that function count."""
    package = Path(package).resolve()
    sites: dict = {}

    def note(message, *args, **kw):
        stack = traceback.extract_stack()[:-1]
        if inside and not any(Path(fr.filename).name == inside[0]
                              and fr.name == inside[1] for fr in stack):
            return
        where = "outside the package"
        for fr in reversed(stack):
            path = Path(fr.filename).resolve()
            if package in path.parents:
                where = f"{path.relative_to(package.parent)}:{fr.lineno} " \
                        f"({fr.name})"
                break
        sites[where] = sites.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites
