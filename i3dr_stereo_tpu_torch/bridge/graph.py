"""In-process pub/sub graph: the thin shell replacing the ROS transport.

The reference wires 6+ OS processes with TCPROS topics, namespace
remapping and services (SURVEY.md §1). On a TPU host the compute all
lives in one fused program, so the graph's job shrinks to: (a) a
host-side routing fabric for sources/sinks/tools, (b) the service +
dynamic-reconfigure surface users script against, (c) namespace/remap
semantics so reference launch layouts translate 1:1.

Topics are type-free channels carrying ``(stamp, data)``; delivery is
synchronous in-process (deterministic, testable). A network transport
(e.g. a real ROS bridge) can attach at the Topic level.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional


class Topic:
    def __init__(self, name: str):
        self.name = name
        self._subs: List[Callable[[float, Any], None]] = []
        self._latch: Optional[tuple] = None
        self.n_published = 0

    def publish(self, stamp: float, data: Any) -> None:
        self.n_published += 1
        self._latch = (stamp, data)
        for cb in list(self._subs):
            cb(stamp, data)

    def subscribe(self, cb: Callable[[float, Any], None], *, latch: bool = False) -> None:
        self._subs.append(cb)
        if latch and self._latch is not None:
            cb(*self._latch)

    @property
    def num_subscribers(self) -> int:
        return len(self._subs)


class Graph:
    """Topic + service registry with remapping."""

    def __init__(self):
        self._topics: Dict[str, Topic] = {}
        self._services: Dict[str, Callable] = {}
        self._lock = threading.Lock()

    # -- topics ---------------------------------------------------------------
    def topic(self, name: str) -> Topic:
        with self._lock:
            t = self._topics.get(name)
            if t is None:
                t = self._topics[name] = Topic(name)
            return t

    def publish(self, name: str, stamp: float, data: Any) -> None:
        self.topic(name).publish(stamp, data)

    def subscribe(self, name: str, cb, *, latch: bool = False) -> None:
        self.topic(name).subscribe(cb, latch=latch)

    def topics(self, pattern: str = "*") -> List[str]:
        return sorted(n for n in self._topics if fnmatch.fnmatch(n, pattern))

    # -- services -------------------------------------------------------------
    def advertise_service(self, name: str, fn: Callable) -> None:
        self._services[name] = fn

    def call(self, name: str, *args, **kw):
        if name not in self._services:
            raise KeyError(f"no such service: {name} "
                           f"(available: {sorted(self._services)})")
        return self._services[name](*args, **kw)

    def services(self) -> List[str]:
        return sorted(self._services)


@dataclasses.dataclass
class Node:
    """Base node: a named participant with namespace + remapping, the
    analog of a ROS node handle."""

    graph: Graph
    name: str
    namespace: str = ""
    remaps: Dict[str, str] = dataclasses.field(default_factory=dict)

    def resolve(self, topic: str) -> str:
        topic = self.remaps.get(topic, topic)
        if topic.startswith("/"):
            return topic
        ns = self.namespace.rstrip("/")
        return f"{ns}/{topic}" if ns else f"/{topic}"

    def publish(self, topic: str, stamp: float, data: Any) -> None:
        self.graph.publish(self.resolve(topic), stamp, data)

    def subscribe(self, topic: str, cb, **kw) -> None:
        self.graph.subscribe(self.resolve(topic), cb, **kw)

    def advertise_service(self, srv: str, fn) -> None:
        self.graph.advertise_service(self.resolve(srv), fn)

    def call(self, srv: str, *a, **kw):
        return self.graph.call(self.resolve(srv), *a, **kw)

    def num_subscribers(self, topic: str) -> int:
        return self.graph.topic(self.resolve(topic)).num_subscribers
