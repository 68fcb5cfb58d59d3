"""BENCHMARK.json against the benchmark's rules of form, and the harness
finding a configuration, a mix and a metric that a later change adds as
files."""

import json
import shutil

import pytest

from portbench import manifest
from portbench.tests.conftest import REPO


def test_manifest_has_no_problems():
    assert manifest.problems(REPO) == []


def test_names_and_units_use_allowed_characters():
    bench = manifest.load(REPO)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.NAME.match(m["name"]) and manifest.UNIT.match(
            m["unit"]), m
    for w in bench["workloads"]:
        assert manifest.NAME.match(w["name"]) and len(w["why"]) <= 200


def test_each_layer_metric_cell_reports_what_it_moves():
    bench = manifest.load(REPO)
    for w in bench["workloads"]:
        got = {m["name"]: m for m in manifest.metrics_of(bench, w["name"])}
        for m in got.values():
            if m["kind"] == "per_layer":
                assert m["moves"] in got, (w["name"], m["name"])
        assert "setup_s" in got


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load(REPO)["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = manifest.cell(REPO, cell)
    assert c.config["name"] == cell.split(".")[0]
    assert c.config["check_limits"]
    for m in c.metrics:
        assert hasattr(manifest.reader(REPO, m["name"]), "read")


def test_a_broken_manifest_is_caught(tmp_path):
    bench = manifest.load(REPO)
    bench["per_layer"][0]["moves"] = "nothing"
    bench["end_to_end"][0]["unit"] = "frames per s"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    found = manifest.problems(tmp_path)
    assert any("moves nothing" in p for p in found)
    assert any("unit" in p for p in found)


def test_a_live_cell_needs_its_configurations_rate(tiny, tmp_path):
    """The trigger's rate belongs to the deployment: a live cell whose
    configuration states none is caught before any run."""
    root = tmp_path / "root"
    shutil.copytree(tiny, root)
    assert manifest.problems(root) == []
    path = root / "portbench/configs/sgbm_1920.json"
    cfg = json.loads(path.read_text())
    del cfg["live_rate_fps"]
    path.write_text(json.dumps(cfg))
    found = manifest.problems(root)
    assert found == ["workload sgbm_1920.live: an open loop needs the "
                     "configuration's live_rate_fps"]


def test_new_files_are_found_and_run(tiny, tmp_path):
    """A later change adds a configuration, a mix and a metric as files
    and entries: the harness finds and runs them without an edit."""
    from portbench import run

    root = tmp_path / "root"
    shutil.copytree(tiny, root)
    cfg = json.loads((root / "portbench/configs/sgbm_1920.json").read_text())
    cfg["name"] = "sgbm_small"
    cfg["matcher"]["window_size"] = 5
    (root / "portbench/configs/sgbm_small.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/replay.json").read_text())
    mix["what"] = "a test"
    (root / "portbench/traffic/replay2.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sgbm_small", "source": "a test",
                             "file": "portbench/configs/sgbm_small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "sgbm_small.replay2",
                               "config": "sgbm_small", "traffic": "replay2",
                               "chips": 1, "why": "a test"})
    # a quantity the benchmark has, under the new cell's own name, needs
    # no file: its reader is found by the quantity's name
    cell_only = {"workloads": ["sgbm_small.replay2"]}
    bench["end_to_end"].append(dict(
        cell_only, name="fps.sgbm_small", unit="frames/s", better="higher",
        bound=0.1, source="host_clock"))
    bench["end_to_end"].append(dict(
        cell_only, name="frames_seen", unit="frames", better="higher",
        bound=0.1, source="host_clock"))
    bench["per_layer"].append(dict(
        cell_only, name="publish_ms.sgbm_small.replay2", unit="ms",
        better="lower", source="host_clock", layer="graph node",
        moves="fps.sgbm_small"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.problems(root) == []
    assert manifest.reader_path(root, "publish_ms.sgbm_small.replay2") \
        == root / "portbench/metrics/publish_ms.py"
    cell = manifest.cell(root, "sgbm_small.replay2")
    res = run.run_cell(root, cell, 5, 1.0, False, device="cpu",
                       log=lambda *a, **k: None)
    assert set(res["metrics"]) == {"fps.sgbm_small", "setup_s",
                                   "frames_seen"}
    assert res["metrics"]["frames_seen"]["value"] >= 1
    assert res["correct"], res["numbers"]
