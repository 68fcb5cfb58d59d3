"""``BENCHMARK.json`` and the files it names, found by name under the
checkout: a configuration in ``portbench/configs/<name>.json``, a traffic
mix in ``portbench/traffic/<name>.json``, a metric's reader in
``portbench/metrics/<name>.py`` or that of the quantity its name begins
with (:func:`reader_path`). A later cell, mix or metric is a new
file and a new entry; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    metrics: list          # every metric entry that applies to this cell


def _find(root: Path, kind: str, name: str, suffix: str) -> Path:
    path = root / "portbench" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def metrics_of(bench: dict, cell: str) -> list:
    """The end-to-end and per-layer metrics a cell reports: those whose
    ``workloads`` list it, or that have no such list."""
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if cell in m.get("workloads", [cell]):
                out.append(dict(m, kind=kind))
    return out


def cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``, its configuration
    and mix read from their files."""
    root = Path(root)
    bench = load(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = json.loads(_find(root, "configs", entry["config"],
                              ".json").read_text())
    mix = json.loads(_find(root, "traffic", entry["traffic"],
                           ".json").read_text())
    return Cell(name, config, mix, int(entry["chips"]),
                metrics_of(bench, name))


def reader_path(root: Path, metric: str) -> Path:
    """``portbench/metrics/<name>.py``, or else the reader of the
    quantity the name begins with: ``publish_ms.sgbm_1920.replay`` falls
    back to ``publish_ms.sgbm_1920.py``, then ``publish_ms.py``. So one
    quantity reported by several cells under names of their own has one
    reader."""
    parts = metric.split(".")
    for k in range(len(parts), 0, -1):
        path = Path(root) / "portbench" / "metrics" / (
            ".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no metrics file for {metric} under "
                            f"{Path(root) / 'portbench' / 'metrics'}")


def reader(root: Path, metric: str):
    """The module of a metric's reader (:func:`reader_path`, loaded from
    its path: a name may hold dots)."""
    path = reader_path(root, metric)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(root: Path) -> list:
    """What in ``BENCHMARK.json`` breaks the benchmark's rules of form:
    names, units, sources, references by name, files found by name, and
    every cell that reports a per-layer metric reporting the end-to-end
    metric it moves. An empty list when none."""
    root = Path(root)
    bench = load(root)
    out = []
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for kind, seq in (("config", names), ("workload", cells),
                      ("metric", metrics)):
        for n in seq:
            if not NAME.match(n):
                out.append(f"{kind} name {n!r}")
        if len(set(seq)) != len(seq):
            out.append(f"two {kind}s share a name")
    for c in bench["configs"]:
        try:
            _find(root, "configs", c["name"], ".json")
        except FileNotFoundError as e:
            out.append(str(e))
        if c["file"] != f"portbench/configs/{c['name']}.json":
            out.append(f"config {c['name']} file {c['file']}")
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"reduced key {k!r}")
    pairs = set()
    for w in bench["workloads"]:
        if w["config"] not in names:
            out.append(f"workload {w['name']}: no config {w['config']}")
        if not NAME.match(w["traffic"]):
            out.append(f"traffic name {w['traffic']!r}")
        try:
            _find(root, "traffic", w["traffic"], ".json")
        except FileNotFoundError as e:
            out.append(str(e))
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair appears twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4) or len(w["why"]) > 200:
            out.append(f"workload {w['name']}: chips or why")
        try:
            mix = json.loads(_find(root, "traffic", w["traffic"],
                                   ".json").read_text())
            config = json.loads(_find(root, "configs", w["config"],
                                      ".json").read_text())
        except FileNotFoundError:
            continue
        rate = config.get("live_rate_fps")
        if mix.get("loop") == "open" and not (
                isinstance(rate, (int, float)) and rate > 0):
            out.append(f"workload {w['name']}: an open loop needs the "
                       f"configuration's live_rate_fps")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                            "higher"):
            out.append(f"metric {m['name']}: unit or better")
        ok_src = SOURCES_E2E if m["name"] in e2e else SOURCES
        if m["source"] not in ok_src:
            out.append(f"metric {m['name']}: source {m['source']}")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']}: no workload {w}")
        try:
            reader_path(root, m["name"])
        except FileNotFoundError as e:
            out.append(str(e))
    for m in bench["end_to_end"]:
        if not 0 < m["bound"] <= 0.25:
            out.append(f"metric {m['name']}: bound {m['bound']}")
    for m in bench["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"metric {m['name']}: moves {m['moves']}")
            continue
        for w in m.get("workloads", cells):
            if w not in moved.get("workloads", cells):
                out.append(f"metric {m['name']}: cell {w} does not report "
                           f"{m['moves']}")
    for w in cells:
        got = {m["name"] for m in metrics_of(bench, w)}
        if "setup_s" not in got or len(got & set(e2e)) < 2 \
                or not got - set(e2e):
            out.append(f"workload {w}: needs setup_s, another end-to-end "
                       f"metric and a per-layer metric")
    return out
