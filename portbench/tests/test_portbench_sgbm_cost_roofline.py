"""sgbm_cost_roofline's counts against counts by hand, and its share
from a synthetic trace."""

from types import SimpleNamespace

from portbench import manifest, peaks
from portbench.tests.conftest import REPO


def _cfg(H, W, **m):
    return {"rig": {"height": H, "width": W},
            "matcher": dict(algorithm="SGBM", **m)}


def test_sgbm_cost_counts():
    r = manifest.reader(REPO, "sgbm_cost_roofline")
    cfg = _cfg(100, 150, disparity_range=96, window_size=9)
    n = 100 * 150 * 96                   # the exact, unpadded volume
    assert r.work(cfg) == (2 * 100 * 150 * 4 + 4 * n, (9 + 16) * n)
    cfg = _cfg(100, 150, disparity_range=96, window_size=1)
    assert r.work(cfg)[1] == 9 * n


def test_sgbm_cost_share_from_a_trace():
    r = manifest.reader(REPO, "sgbm_cost_roofline")
    cfg = _cfg(1080, 1920, disparity_range=480, window_size=9)
    nbytes, nops = r.work(cfg)
    least, by = peaks.least_seconds(nbytes, nops)
    assert by == "bytes"
    assert abs(least - 3.998e9 / 3.35e12) < 1e-5
    kernel_us = 4 * least * 1e6          # two frames, 2x the least each
    t = SimpleNamespace(frames=2, device=[
        (0.0, kernel_us / 2, "void (anonymous namespace)::"
                             "bt_box_cost_kernel<4>(BoxArgs)"),
        (kernel_us, kernel_us * 1.5, "void bt_box_cost_kernel<4>(X)"),
        (0.0, 1e9, "void sgm_volume_kernel<float>(VolumeArgs)")])
    share = r.read(SimpleNamespace(trace=t, config=cfg))
    assert abs(share - 100.0 * 2 * least / (kernel_us * 1e-6)) < 1e-9
    assert abs(share - 50.0) < 1e-9
    # a program without the kernel, as the parent: nothing to read
    assert r.read(SimpleNamespace(trace=SimpleNamespace(
        frames=1, device=[(0, 5, "sgm_volume_kernel")]), config=cfg)) is None
    assert r.read(SimpleNamespace(trace=None, config=cfg)) is None
