"""Mapping consumers for the /points2 hook (reference: rtabmap + pcl,
launch/stereo_processing.launch:88-122): TSDF fusion and the depth
odometry that poses it."""

from i3dr_stereo_tpu_torch.mapping.odometry import (
    DepthOdometry,
    estimate_motion,
    render_plane_depth,
)
from i3dr_stereo_tpu_torch.mapping.tsdf import TSDFVolume, make_map_consumer

__all__ = ["TSDFVolume", "make_map_consumer", "DepthOdometry",
           "estimate_motion", "render_plane_depth"]
