"""The comparison that decides ``correct``, on the CPU at a tiny size:
the port (its plain twins) against the reference through a whole run of
each cell, the bfloat16 control failing the limits, and each fault the
cells can have, planted under the timed path, turning ``correct``
false."""

import dataclasses

import pytest
import torch

from portbench import check, control, inputs, manifest, run
from portbench.reference.pipeline import Reference

CELLS = [w["name"] for w in manifest.load(
    __import__("portbench.tests.conftest", fromlist=["REPO"]).REPO)
    ["workloads"]]
quiet = dict(log=lambda *a, **k: None)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_against_the_reference(tiny, cell):
    c = manifest.cell(tiny, cell)
    res = run.run_cell(tiny, c, 2 ** 31 + 11, 1.0, False, device="cpu",
                       **quiet)
    assert res["correct"], res["numbers"]
    assert res["compared"] == 1 and res["failed"] == 0
    assert res["numbers"] == dict.fromkeys(check.NUMBERS, 0.0)
    assert set(res["metrics"]) == {m["name"] for m in c.metrics
                                   if m["kind"] == "end_to_end"}


@pytest.mark.parametrize("cell", ["i3drsgm_2448.replay", "sgbm_1920.replay"])
def test_the_control_fails_the_limits(tiny, cell):
    rows = []
    control.readings(tiny, cell, [3, 4, 5], False, device="cpu",
                     log=lambda line, **k: rows.append(line))
    limits = manifest.cell(tiny, cell).config["check_limits"]
    import json
    for line in rows:
        got = json.loads(line)["control"]
        assert any(got[k] > limits[k] for k in check.NUMBERS), got


def stale():
    """A step that returns its state unchanged: each frame is handed the
    previous frame's result."""
    last = {}

    def fault(res):
        prev = last.get("res", res)
        last["res"] = res
        return prev
    return fault


def alter():
    """1 px added to the disparity in the middle sixteenth of the frame."""
    def fault(res):
        d = res.disparity.clone()
        H, W = d.shape[-2:]
        d[..., 3 * H // 8:5 * H // 8, 3 * W // 8:5 * W // 8] += 1.0
        return dataclasses.replace(res, disparity=d)
    return fault


def half():
    """The lower half of the frame dropped from ``valid``."""
    def fault(res):
        v = res.valid.clone()
        v[..., v.shape[-2] // 2:, :] = False
        return dataclasses.replace(res, valid=v)
    return fault


def boom():
    def fault(res):
        raise RuntimeError("planted")
    return fault


def plant(monkeypatch, make):
    """Launch the graph as a run does, with ``make()``'s fault rewriting
    what the pipeline's ``process`` returns, under the timed path."""
    launch = run.launch

    def faulty(config, device):
        lg, pipe = launch(config, device)
        orig, fault = pipe.process, make()
        pipe.process = lambda left, right: fault(orig(left, right))
        return lg, pipe
    monkeypatch.setattr(run, "launch", faulty)


@pytest.mark.parametrize("make", [stale, alter, half],
                         ids=["stale", "alter", "half"])
@pytest.mark.parametrize("cell", ["i3drsgm_2448.replay", "sgbm_1920.live"])
def test_a_planted_fault_makes_the_run_incorrect(tiny, cell, make,
                                                 monkeypatch):
    plant(monkeypatch, make)
    c = manifest.cell(tiny, cell)
    res = run.run_cell(tiny, c, 77, 1.0, False, device="cpu", **quiet)
    assert not res["correct"], (make.__name__, res["numbers"])


def test_a_frame_that_never_comes_makes_the_run_incorrect(tiny, monkeypatch):
    plant(monkeypatch, boom)
    c = manifest.cell(tiny, "sgbm_1920.replay")
    with pytest.raises(RuntimeError):
        # a warm-up frame that fails stops the run before the window
        run.run_cell(tiny, c, 1, 1.0, False, device="cpu", **quiet)


def test_the_reference_rectifies_the_raw_frames_back(tiny):
    """The raw frames are the scene seen through the rig: rectifying
    them gives the scene's disparity back within the repo's gate."""
    c = manifest.cell(tiny, "sgbm_1920.replay")
    pool = inputs.make_frames(c.config, 9, "cpu")
    out = Reference(c.config, "cpu").frame(pool.left[0], pool.right[0])
    med, dens = check.accuracy(check.as_published(out), pool.gt[0],
                               pool.gt_valid[0])
    assert med < 0.25 and dens > 0.5


def test_inputs_are_a_function_of_the_seed(tiny):
    c = manifest.cell(tiny, "i3drsgm_2448.replay")
    a = inputs.make_frames(c.config, 2 ** 33 + 5, "cpu")
    b = inputs.make_frames(c.config, 2 ** 33 + 5, "cpu")
    d = inputs.make_frames(c.config, 2 ** 33 + 6, "cpu")
    assert all((x == y).all() for x, y in zip(a.left, b.left))
    assert not (a.left[0] == d.left[0]).all()
    assert len({x.tobytes() for x in a.left}) == len(a.left)
