"""The two rooflines' counts against counts by hand at small shapes."""

from types import SimpleNamespace

from portbench import manifest, peaks
from portbench.tests.conftest import REPO


def _cfg(alg, H, W, **m):
    return {"rig": {"height": H, "width": W},
            "matcher": dict(algorithm=alg, **m)}


def test_census_sgm_wta_counts():
    r = manifest.reader(REPO, "census_sgm_wta_roofline")
    cfg = _cfg("I3DRSGM", 200, 300, max_pyramid_level=2, census_width=9,
               census_height=9, num_directions=4)
    # level 0: 200x300 -> 256x384; level 1: 100x150 -> 128x256
    # NW = ceil(80 / 32) = 3; D = 32
    shapes = [(256, 384), (128, 256)]
    nbytes = sum(2 * h * w * 3 * 4 + h * w * 32 + h * w * 4
                 for h, w in shapes)
    nops = sum(h * w * 32 * 3 + 2 * h * w * 32 * 4 for h, w in shapes)
    assert r.work(cfg) == (nbytes, nops)


def test_sgm_aggregate_counts():
    r = manifest.reader(REPO, "sgm_aggregate_roofline")
    cfg = _cfg("SGBM", 100, 150, disparity_range=96, num_directions=8)
    H, W, D = 104, 152, 128      # padded as the stage pads
    assert r.work(cfg) == (2 * H * W * D * 4, 2 * H * W * D * 8)


def test_share_from_a_trace():
    r = manifest.reader(REPO, "sgm_aggregate_roofline")
    cfg = _cfg("SGBM", 1080, 1920, disparity_range=128, num_directions=8)
    nbytes, nops = r.work(cfg)
    least, by = peaks.least_seconds(nbytes, nops)
    assert by == "bytes"
    kernel_us = 2 * least * 1e6          # the kernel took twice the least
    t = SimpleNamespace(frames=1, device=[
        (0.0, kernel_us / 2, "void sgm_volume_kernel<float>(VolumeArgs)"),
        (kernel_us, kernel_us * 1.5, "void sgm_volume_kernel<float>(X)"),
        (0.0, 1e9, "something_else")])
    share = r.read(SimpleNamespace(trace=t, config=cfg))
    assert abs(share - 50.0) < 1e-9
    assert r.read(SimpleNamespace(trace=SimpleNamespace(
        frames=1, device=[(0, 5, "other")]), config=cfg)) is None
