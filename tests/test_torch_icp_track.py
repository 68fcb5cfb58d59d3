"""Torch port: the ICP track as the ``icp_step`` kernel takes it
(``mapping/odometry.py``): the packed record, the level table of one
launch, and the wrapper's checks.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to the
twin there). On the CPU:

- ``pack_maps`` gives per level the current map (H, W, 4) and the record
  (H, W, 8) = [vertex, valid, normal, ok], field for field what
  ``_backproject`` and ``_normals`` give, on odd sizes too;
- the twin over the record gives states bit-equal to the twin over the
  earlier (H, W, 4) vertex and normal maps (``_step_two_maps`` below: the
  gather as it stood before the record) on the same depth, step by step
  at every level;
- the table of one launch (``track_levels`` / ``launch_table``: each
  level's maps, size, steps ``iters[min(li, len - 1)]``, intrinsics and
  1 / (H W), coarse to fine) is what ``_track(plain=True)`` runs, and a
  level of 0 steps leaves rmse and the fraction 0;
- the wrappers raise ``ValueError`` on a map of the wrong dtype, shape,
  layout or alignment, on a short state, a negative step count and too
  many levels.
"""

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu_torch.mapping import odometry as podo
from i3dr_stereo_tpu_torch.mapping import render_plane_depth

torch.set_num_threads(2)

H, W = 121, 157            # odd: the pyramid's H // 2 and W // 2 drop a row
K = np.array([[140.0, 0.0, 78.0], [0.0, 140.0, 60.0], [0.0, 0.0, 1.0]],
             np.float32)
SCENE = [
    ((0.0, 0.0, 3.0), (0.0, 0.0, -1.0), (3.0, 3.0, 0.01)),
    ((-1.0, 0.0, 2.2), (1.0, 0.0, -0.7), (0.6, 1.6, 0.7)),
    ((0.0, 0.9, 2.0), (0.0, -1.0, -0.4), (1.8, 0.5, 0.9)),
    ((0.45, -0.25, 1.6), (0.0, 0.0, -1.0), (0.35, 0.25, 0.01)),
]
XI = [0.014, -0.017, 0.009, 0.02, -0.015, 0.03]


@pytest.fixture(scope="module")
def pyramids():
    """Two frames' packed pyramids (4 levels) and the current depth."""
    T2 = podo._se3_exp(torch.tensor(XI)).numpy()
    d1 = render_plane_depth(K, np.eye(4), SCENE, H, W)
    d2 = render_plane_depth(K, T2, SCENE, H, W)
    return (podo.pack_maps(torch.from_numpy(d1), K, 4),
            podo.pack_maps(torch.from_numpy(d2), K, 4), d2)


def _identity_state():
    state = torch.zeros(podo.STATE)
    state[:16] = torch.eye(4).reshape(-1)
    return state


def _step_two_maps(cur, prev_v, prev_n, cam, state, dist_thresh):
    """The twin's step over the earlier layout, two (H, W, 4) maps of the
    previous frame ([vertex, valid] and [normal, ok]); the arithmetic is
    ``icp_step_plain``'s, the gather reads the two maps."""
    Hc, Wc = cur.shape[:2]
    fx, fy, cx, cy = (torch.full((), float(v)) for v in cam)
    T = state[:16].reshape(4, 4)
    Vc, okc = cur[..., :3], cur[..., 3] > 0
    p = torch.stack([(Vc[..., 0] * T[r, 0] + Vc[..., 1] * T[r, 1]
                      + Vc[..., 2] * T[r, 2]) + T[r, 3] for r in range(3)],
                    dim=-1)
    pz = p[..., 2].clamp(min=1e-9)
    ui = torch.round((fx * p[..., 0]) / pz + cx).clamp(-1, Wc).long()
    vi = torch.round((fy * p[..., 1]) / pz + cy).clamp(-1, Hc).long()
    inb = (p[..., 2] > 1e-6) & (ui >= 0) & (ui < Wc) & (vi >= 0) & (vi < Hc)
    flat = vi.clamp(0, Hc - 1) * Wc + ui.clamp(0, Wc - 1)
    q = prev_v.reshape(-1, 4)[flat][..., :3]
    nn = prev_n.reshape(-1, 4)[flat]
    n, hit_ok = nn[..., :3], nn[..., 3] > 0
    d = p - q
    r = podo._dot3(d, n)
    thr2, inv_hw = podo._step_scalars(dist_thresh, Hc, Wc)
    close = podo._dot3(d, d) < torch.full((), float(thr2))
    wgt = (okc & inb & hit_ok & close).to(torch.float32)
    J = torch.cat([podo._cross(p, n), n], dim=-1).reshape(-1, 6)
    Jw = J * wgt.reshape(-1, 1)
    A = Jw.T @ J
    b = -(Jw.T @ r.reshape(-1))
    sr2, sw = (wgt * r * r).sum(), wgt.sum()
    xi = torch.linalg.solve_ex(A + 1e-6 * torch.eye(6), b)[0]
    out = torch.zeros(podo.STATE)
    out[:16] = (podo._se3_exp(xi) @ T).reshape(-1)
    nw = sw.clamp(min=1.0)
    out[16] = torch.sqrt(sr2 / nw)
    out[17] = nw * float(inv_hw)
    out[18:54] = A.reshape(-1)
    out[54:60] = b
    out[60], out[61] = sr2, sw
    return out


def test_pack_maps_record_fields(pyramids):
    """Per level: cur = [vertex, valid]; the record = [vertex, valid,
    normal, ok & valid], as _backproject and _normals give them."""
    _, cur, depth = pyramids
    d = torch.from_numpy(depth)
    for li, (c, rec) in enumerate(cur):
        if li:
            d = podo._downsample_depth(d)
        assert tuple(c.shape) == (H >> li, W >> li, 4)
        assert tuple(rec.shape) == (H >> li, W >> li, 8)
        assert c.dtype == rec.dtype == torch.float32
        assert c.is_contiguous() and rec.is_contiguous()
        valid = d > 0
        V = podo._backproject(d, torch.from_numpy(podo.level_intrinsics(K,
                                                                       li)))
        N, ok = podo._normals(V, valid)
        assert torch.equal(c[..., :3], V)
        assert torch.equal(c[..., 3], valid.float())
        assert torch.equal(rec[..., :4], c)
        assert torch.equal(rec[..., 4:7], N)
        assert torch.equal(rec[..., 7], (ok & valid).float())
        assert bool(valid.any()) and bool(ok.any())


@pytest.mark.parametrize("level", range(4))
def test_twin_over_record_equals_two_maps(pyramids, level):
    """The same depth through the record and through the two (H, W, 4)
    maps: bit-equal states, 3 steps from the identity."""
    prev, cur, _ = pyramids
    c, rec = cur[level][0], prev[level][1]
    prev_v = rec[..., :4].contiguous()
    prev_n = rec[..., 4:].contiguous()
    Kl = podo.level_intrinsics(K, level)
    cam = (Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2])
    a = b = _identity_state()
    for _ in range(3):
        a = podo.icp_step(c, rec, cam, a, 0.5)
        b = _step_two_maps(c, prev_v, prev_n, cam, b, 0.5)
        assert torch.equal(a, b)
    assert float(a[61]) > 0


@pytest.mark.parametrize("iters", [(4, 7, 10), (3,), (2, 0), (0, 2, 3, 1),
                                   (1, 2, 0, 3, 5)])
def test_launch_table_is_what_the_twin_runs(pyramids, iters):
    """The table of one launch, coarse to fine, against the pyramid and
    against _track(plain=True); a finest level of 0 steps leaves rmse and
    the fraction 0."""
    prev, cur, _ = pyramids
    levels = podo.track_levels(prev, cur, K, iters)
    n = len(cur)
    assert len(levels) == n
    maps, dims, cams, thr2 = podo.launch_table(levels, 0.5)
    assert maps.dtype == np.uint64 and dims.dtype == np.int32
    assert cams.dtype == np.float32
    assert thr2 == np.float32(0.25)
    state = _identity_state()
    for i, (c, rec, cam, steps) in enumerate(levels):
        li = n - 1 - i                                  # coarse -> fine
        assert c is cur[li][0] and rec is prev[li][1]
        assert steps == iters[min(li, len(iters) - 1)]
        Kl = podo.level_intrinsics(K, li)
        assert cam == (Kl[0, 0], Kl[1, 1], Kl[0, 2], Kl[1, 2])
        assert tuple(dims[i]) == (H >> li, W >> li, steps)
        np.testing.assert_array_equal(
            cams[i], np.array([*cam, np.float32(1) / np.float32(
                (H >> li) * (W >> li))], np.float32))
        assert tuple(maps[i]) == (c.data_ptr(), rec.data_ptr())
        state = podo._icp_level(prev[li], cur[li], cam, state, steps, 0.5)
    track = podo._track(prev, cur, K, torch.eye(4), iters, plain=True)
    assert torch.equal(track, state)
    assert float(track[61]) > 0
    if levels[-1][3] == 0:
        assert float(track[16]) == 0.0 and float(track[17]) == 0.0
    else:
        assert float(track[17]) > 0.3


def _maps(h=6, w=5, *, cur_off=0, rec_off=0, dtype=torch.float32):
    """A level's maps, their storage offset by cur_off / rec_off floats."""
    cur = torch.zeros(h * w * 4 + cur_off, dtype=dtype)[cur_off:]
    rec = torch.zeros(h * w * 8 + rec_off, dtype=dtype)[rec_off:]
    return cur.reshape(h, w, 4), rec.reshape(h, w, 8)


BAD = {
    "float64": lambda: _maps(dtype=torch.float64),
    "cur 3 channels": lambda: (torch.zeros(6, 5, 3), _maps()[1]),
    "record 4 channels": lambda: (_maps()[0], torch.zeros(6, 5, 4)),
    "sizes differ": lambda: (_maps()[0], _maps(7, 5)[1]),
    "empty": lambda: _maps(0, 5),
    "cur off 16 bytes": lambda: _maps(cur_off=1),
    "record off 32 bytes": lambda: _maps(rec_off=4),
    "not contiguous": lambda: (_maps(5, 6)[0].transpose(0, 1), _maps()[1]),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_icp_step_checks_raise(case):
    cur, rec = BAD[case]()
    with pytest.raises(ValueError):
        podo.icp_step(cur, rec, (1.0, 1.0, 2.0, 2.0), _identity_state(),
                      0.5)


def test_state_steps_and_levels_checked():
    cur, rec = _maps()
    cam = (1.0, 1.0, 2.0, 2.0)
    with pytest.raises(ValueError):
        podo.icp_step(cur, rec, cam, torch.zeros(podo.STATE - 2), 0.5)
    with pytest.raises(ValueError):
        podo.icp_step(cur, rec, cam, torch.zeros(podo.STATE,
                                                 dtype=torch.float64), 0.5)
    with pytest.raises(ValueError):
        podo.launch_table([(cur, rec, cam, -1)], 0.5)
    with pytest.raises(ValueError):
        podo.launch_table([(cur, rec, cam, 1)] * (podo.MAX_LEVELS + 1), 0.5)
    with pytest.raises(ValueError):
        podo.icp_track([(cur, rec, cam, 1)], torch.zeros(podo.STATE - 1),
                       0.5)
