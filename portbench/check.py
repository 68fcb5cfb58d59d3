"""The comparison that decides ``correct``: what the graph published for
a frame of the window against what the plain reference works out from the
same raw pair. Four numbers, each held to the configuration's limit
(``check_limits`` in its file, set from sound runs and the control, see
PERF.md):

- ``rect_max_abs``: the largest |difference| of the two rectified images,
  in grey levels;
- ``disp_mismatch``: the share of pixels whose valid flag differs, or
  whose disparity differs by more than ``DISP_TOL`` px where both are
  valid;
- ``depth_mismatch``: the share of pixels whose depth differs by more
  than ``REL_TOL`` of the reference's (0 where invalid on either side);
- ``cloud_mismatch``: the share of points whose valid flag differs, whose
  x, y or z differs by more than ``REL_TOL`` of the reference's where both
  are valid, or whose grey value differs by more than ``GREY_TOL``."""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("rect_max_abs", "disp_mismatch", "depth_mismatch",
           "cloud_mismatch")
DISP_TOL = 0.01
REL_TOL = 1e-4
GREY_TOL = 1e-3


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def _rel_off(a, b) -> torch.Tensor:
    return (a - b).abs() > REL_TOL * torch.clamp(b.abs(), min=1e-6)


@torch.no_grad()
def compare(published: dict, ref: dict) -> dict:
    """``published``: the frame's payloads by topic, as the collector
    received them; ``ref``: :meth:`Reference.frame`'s tensors."""
    dev = ref["disparity"].device
    rect = max(float((_t(published[t], dev) - ref[k]).abs().max())
               for t, k in (("left/image_rect", "rect_left"),
                            ("right/image_rect", "rect_right")))
    d = published["disparity"]
    disp, valid = _t(d["disparity"], dev), _t(d["valid"], dev)
    rdisp, rvalid = ref["disparity"], ref["valid"]
    off = (valid != rvalid) | (valid & rvalid
                               & ((disp - rdisp).abs() > DISP_TOL))
    depth = _t(published["depth"], dev)
    doff = ((depth > 0) != (ref["depth"] > 0)) | _rel_off(depth, ref["depth"])
    pc = published["points2"]
    cv, rcv = _t(pc["valid"], dev), ref["cloud_valid"]
    xyz = _t(pc["xyz"], dev)
    coff = (cv != rcv) | (cv & rcv & _rel_off(xyz, ref["xyz"]).any(-1)) \
        | ((_t(pc["rgb"], dev) - ref["rgb"]).abs() > GREY_TOL).any(-1)
    return {"rect_max_abs": rect,
            "disp_mismatch": float(off.float().mean()),
            "depth_mismatch": float(doff.float().mean()),
            "cloud_mismatch": float(coff.float().mean())}


def as_published(ref: dict) -> dict:
    """A reference frame laid out as the graph publishes it (the control
    and the tests put the reference in the program's place)."""
    n = lambda x: x.detach().cpu().numpy()
    return {"left/image_rect": n(ref["rect_left"]),
            "right/image_rect": n(ref["rect_right"]),
            "disparity": {"disparity": n(ref["disparity"]),
                          "valid": n(ref["valid"])},
            "depth": n(ref["depth"]),
            "points2": {"xyz": n(ref["xyz"]), "valid": n(ref["cloud_valid"]),
                        "rgb": n(ref["rgb"])}}


def worst(readings: list) -> dict:
    """The largest reading of each number over the frames compared."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def accuracy(published: dict, gt, gt_valid) -> tuple:
    """(median |d - GT| over pixels valid in both, density): the repo's
    accuracy gate (< 0.25 px, > 0.5), for an earlier line only (the
    ground truth went through two resamplings)."""
    d = published["disparity"]
    disp, valid = np.asarray(d["disparity"]), np.asarray(d["valid"])
    both = valid & gt_valid
    err = np.abs(disp[both] - gt[both])
    return (float(np.median(err)) if err.size else float("nan"),
            float(valid.mean()))
