"""The benchmark's own tests: on the CPU at tiny sizes, except those
marked ``card``, which run a cell on the card and skip without one
(decided inside the test). Run from the repository root:

    python -m pytest portbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def tiny_root(dest: Path) -> Path:
    """A checkout-like root whose BENCHMARK.json names the benchmark's own
    cells, metrics and readers, with every configuration cut to a tiny
    frame and a slow trigger, for the CPU."""
    for d in ("configs", "traffic", "metrics"):
        (dest / "portbench" / d).mkdir(parents=True)
    for f in (REPO / "portbench" / "metrics").glob("*.py"):
        shutil.copy(f, dest / "portbench" / "metrics" / f.name)
    for f in (REPO / "portbench" / "traffic").glob("*.json"):
        shutil.copy(f, dest / "portbench" / "traffic" / f.name)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        if cfg["matcher"]["algorithm"] == "I3DRSGM":
            W, H, f = 320, 256, 320.0
            cfg["matcher"].update(min_disparity=40, disparity_range=64,
                                  max_pyramid_level=3)
            cfg["scene"].update(max_disp=100, background_disp=44, layers=3)
        else:
            W, H, f = 192, 128, 190.0
            cfg["matcher"].update(min_disparity=20, disparity_range=32)
            cfg["scene"].update(max_disp=48, background_disp=22, layers=3)
        cfg["rig"].update(
            width=W, height=H, K=[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
            P=[[0.99 * f, 0, W / 2 - 2, 0], [0, 0.99 * f, H / 2 - 1, 0],
               [0, 0, 1, 0]])
        cfg["live_rate_fps"] = 2.0
        (dest / c["file"]).write_text(json.dumps(cfg))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def small_pool(monkeypatch):
    """A few raw pairs, one warm-up frame and two traced frames a run."""
    from portbench import inputs, load

    monkeypatch.setattr(inputs, "FRAMES", 4)
    monkeypatch.setattr(inputs, "SCENES", 2)
    monkeypatch.setattr(inputs, "SHIFT_PX", 13)
    monkeypatch.setattr(load, "WARMUP_FRAMES", 1)
    monkeypatch.setattr(load, "TRACE_FRAMES", 2)
