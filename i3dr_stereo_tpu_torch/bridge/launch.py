"""Launch-profile presets: the reference's launch/*.launch graphs as
composable Python builders.

Reference launch files (SURVEY.md §2.3) -> builders here:

- stereo_matcher.launch  -> :func:`launch_stereo_matcher` (matcher +
  depth + optional rectify/crop, with the six per-algorithm default
  parameter blocks of stereo_matcher.launch:20-108)
- stereo_capture.launch  -> :func:`launch_capture` (source + control
  nodes; synthetic or directory-replay sources)
- stereo_bag.launch      -> :func:`launch_replay` (directory replay
  through the full pipeline, the offline regression path)
- stereo_camera.launch   -> :func:`launch_stereo_camera` (capture +
  matcher, the live top-level)

Torch port of ``i3dr_stereo_tpu.bridge.launch``: the builders that start
a matcher take ``device`` (the card unless the caller asks for the CPU;
a missing card raises) and pass it to every node that computes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, Optional, Tuple

from i3dr_stereo_tpu_torch.bridge.graph import Graph
from i3dr_stereo_tpu_torch.bridge.nodes import (
    CameraControlNode,
    CropByDisparityNode,
    GenerateDisparityNode,
    RectifyNode,
    TriggerNode,
    warmup_matchers,
)
from i3dr_stereo_tpu_torch.config.params import (
    ALGORITHM_DEFAULTS,
    Algorithm,
    MatcherConfig,
    PointCloudConfig,
)
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.sources import StereoDirectorySource, SyntheticStereoSource


@dataclasses.dataclass
class LaunchedGraph:
    graph: Graph
    nodes: dict

    def node(self, name: str):
        return self.nodes[name]


def launch_stereo_matcher(rig: StereoRig, *,
                          stereo_algorithm: Algorithm = Algorithm.BM,
                          namespace: str = "/stereo",
                          config: Optional[MatcherConfig] = None,
                          cloud: Optional[PointCloudConfig] = None,
                          rectify_inputs: bool = True,
                          with_crop: bool = False,
                          with_standalone_rectify: bool = False,
                          warmup: bool = True,
                          graph: Optional[Graph] = None,
                          device="cuda") -> LaunchedGraph:
    """The stereo_matcher.launch graph: per-algorithm defaults + matcher
    node + depth (fused) + optional crop/rectify nodes, on ``device``."""
    g = graph or Graph()
    cfg = config or ALGORITHM_DEFAULTS[stereo_algorithm]
    cfg = cfg.replace(algorithm=stereo_algorithm)
    cl = cloud or PointCloudConfig()
    if warmup:
        warmup_matchers(cfg, device=device)  # init_stereo_matchers analog
    nodes = {
        "generate_disparity": GenerateDisparityNode(
            g, rig, cfg, cl, namespace=namespace, rectify=rectify_inputs,
            device=device),
    }
    if with_crop:
        nodes["crop"] = CropByDisparityNode(g, namespace=namespace,
                                            device=device)
    if with_standalone_rectify:
        nodes["rectify"] = RectifyNode(g, rig, namespace=namespace + "_no_laser",
                                       device=device)
    return LaunchedGraph(graph=g, nodes=nodes)


def launch_capture(*, source: Optional[SyntheticStereoSource] = None,
                   namespace: str = "/stereo",
                   left_serial: str = "00000001", right_serial: str = "00000002",
                   split_laser: bool = False,
                   graph: Optional[Graph] = None) -> LaunchedGraph:
    """stereo_capture.launch: two camera-control nodes + trigger."""
    g = graph or Graph()
    nodes = {
        "left_ctrl": CameraControlNode(g, left_serial, f"{namespace}/left",
                                       split_laser=split_laser),
        "right_ctrl": CameraControlNode(g, right_serial, f"{namespace}/right",
                                        split_laser=split_laser),
        "trigger": TriggerNode(g),
        "source": source or SyntheticStereoSource(),
    }
    return LaunchedGraph(graph=g, nodes=nodes)


def launch_stereo_camera(rig: StereoRig, *,
                         stereo_algorithm: Algorithm = Algorithm.BM,
                         namespace: str = "/stereo",
                         source: Optional[SyntheticStereoSource] = None,
                         **matcher_kw) -> LaunchedGraph:
    """Top-level live graph: capture + matcher (stereo_camera.launch)."""
    g = Graph()
    cap = launch_capture(source=source, namespace=namespace, graph=g)
    mat = launch_stereo_matcher(rig, stereo_algorithm=stereo_algorithm,
                                namespace=namespace, graph=g, **matcher_kw)
    return LaunchedGraph(graph=g, nodes={**cap.nodes, **mat.nodes})


def run_source(lg: LaunchedGraph, namespace: str = "/stereo",
               n_frames: Optional[int] = None,
               stop: Optional[threading.Event] = None) -> int:
    """Feed the launched graph from its source (the drivers' job); with
    ``stop``, end after the pair in flight once it is set."""
    src = lg.nodes["source"]
    n = 0
    for l, r in src.pairs():
        lg.graph.publish(f"{namespace}/left/image_raw", l.stamp, l.data)
        lg.graph.publish(f"{namespace}/right/image_raw", r.stamp, r.data)
        n += 1
        if n_frames is not None and n >= n_frames:
            break
        if stop is not None and stop.is_set():
            break
    return n


def launch_single_camera(*, serial: str = "00000001",
                         namespace: str = "/phobos_nuclear",
                         source=None,
                         graph: Optional[Graph] = None) -> LaunchedGraph:
    """single_cam_capture.launch: one camera-control node (reference
    defaults: 1920x1200 @ 15 FPS, single_cam_capture.launch:9-16)."""
    g = graph or Graph()
    nodes = {
        "ctrl": CameraControlNode(g, serial, namespace),
        "source": source or SyntheticStereoSource(),
    }
    return LaunchedGraph(graph=g, nodes=nodes)


def launch_description(name: str = "i3dr_stereo", *, baseline: float = 0.3,
                       toe_in: float = 0.0) -> "RigDescription":
    """stereo_description.launch: publish the TF frame tree of the rig
    (urdf/i3dr_stereo_camera.urdf.xacro:8-19 frame names)."""
    from i3dr_stereo_tpu_torch.core.frames import RigDescription

    return RigDescription(camera_name=name, baseline=baseline,
                          toe_in_l=toe_in, toe_in_r=toe_in)


def launch_processing(rig: StereoRig, *,
                      stereo_algorithm: Algorithm = Algorithm.I3DRSGM,
                      namespace: str = "/stereo",
                      with_crop: bool = True,
                      map_consumer=None,
                      **matcher_kw) -> LaunchedGraph:
    """stereo_processing.launch: matcher + depth/cloud + the downstream
    mapping hook (the reference wires i3dr_rtabmap / pcl tools here,
    stereo_processing.launch:88-122; those are external packages — the
    hook subscribes ``map_consumer(stamp, points)`` to the cloud topic)."""
    lg = launch_stereo_matcher(rig, stereo_algorithm=stereo_algorithm,
                               namespace=namespace, with_crop=with_crop,
                               **matcher_kw)
    if map_consumer is not None:
        lg.graph.subscribe(f"{namespace}/points2", map_consumer)
    return lg


def launch_stereo_calibration(*, namespace: str = "/stereo",
                              board=None, n_target: int = 13,
                              graph: Optional[Graph] = None) -> LaunchedGraph:
    """stereo_calibration.launch: collect synchronized chessboard pairs
    off the raw topics and solve the stereo calibration once ``n_target``
    boards are seen (the reference delegates to ROS camera_calibration's
    cameracalibrator.py, stereo_calibration.launch:48-56)."""
    import numpy as np

    from i3dr_stereo_tpu_torch.io.calibrate import ChessboardSpec, calibrate_stereo
    from i3dr_stereo_tpu_torch.pipeline.pairing import ApproximateTimeSync

    g = graph or Graph()
    spec = board or ChessboardSpec()
    state = {"lefts": [], "rights": [], "result": None}
    sync = ApproximateTimeSync(slop=0.05)

    def _drain():
        for l, r in sync.pop_pairs():
            if state["result"] is not None:
                return
            state["lefts"].append(np.asarray(l.data))
            state["rights"].append(np.asarray(r.data))
            if len(state["lefts"]) >= n_target:
                state["result"] = calibrate_stereo(state["lefts"],
                                                   state["rights"], spec)

    def _on_left(stamp, img):
        sync.push_left(stamp, img)
        _drain()

    def _on_right(stamp, img):
        sync.push_right(stamp, img)
        _drain()

    g.subscribe(f"{namespace}/left/image_raw", _on_left)
    g.subscribe(f"{namespace}/right/image_raw", _on_right)
    return LaunchedGraph(graph=g, nodes={"calibrator": state})


def launch_replay(rig: StereoRig, directory: str, *,
                  stereo_algorithm: Algorithm = Algorithm.SGBM,
                  namespace: str = "/stereo", fps: float = 5.0,
                  rate: float = 0.0,
                  **matcher_kw) -> Tuple[LaunchedGraph, Iterator]:
    """stereo_bag.launch: replay a recorded directory through the full
    matcher graph (the offline regression path).

    ``rate`` > 0 paces publishes by the RECORDED stamps at that multiple
    of real time — ``rosbag play --clock -r <rate>``
    (launch/stereo_bag_capture.launch:35-38): rate=1 replays in real
    time, rate=2 at double speed. rate=0 (default) runs
    as-fast-as-possible (the offline regression mode).
    """
    lg = launch_stereo_matcher(rig, stereo_algorithm=stereo_algorithm,
                               namespace=namespace, **matcher_kw)
    src = StereoDirectorySource(directory, fps=fps)

    def run():
        import time as _time

        t0 = wall0 = None
        for l, r in src.pairs():
            if rate and rate > 0:
                if t0 is None:
                    t0, wall0 = l.stamp, _time.monotonic()
                else:
                    delay = wall0 + (l.stamp - t0) / rate - _time.monotonic()
                    if delay > 0:
                        _time.sleep(delay)
            lg.graph.publish(f"{namespace}/left/image_raw", l.stamp, l.data)
            lg.graph.publish(f"{namespace}/right/image_raw", r.stamp, r.data)
            yield l.stamp

    return lg, run()
