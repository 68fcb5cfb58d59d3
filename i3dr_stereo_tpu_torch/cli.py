"""Command-line interface — the `roslaunch` surface of the framework
(torch port of ``i3dr_stereo_tpu.cli``).

    python -m i3dr_stereo_tpu_torch.cli match L.png R.png --algorithm SGBM \\
        --disparity-range 128 -o out/
    python -m i3dr_stereo_tpu_torch.cli replay captures/ --algorithm I3DRSGM
    python -m i3dr_stereo_tpu_torch.cli live --frames 10 --save-view view.png
    python -m i3dr_stereo_tpu_torch.cli live --gige 10.0.0.2,10.0.0.3 \\
        --width 2448 --height 2048 --algorithm I3DRSGM
    python -m i3dr_stereo_tpu_torch.cli live --serve --duration 60
    python -m i3dr_stereo_tpu_torch.cli info
    python -m i3dr_stereo_tpu_torch.cli bench --config all

Mirrors the reference's launch arguments (stereo_algorithm,
min_disparity, disparity_range, calibration paths, depth_max, ...;
launch/stereo_matcher.launch:20-143). ``--device`` (default ``cuda``)
picks where the matcher runs: the card unless the caller asks for the
CPU, and a missing card raises. ``live`` runs the synthetic source, two
GigE Vision cameras (``--gige``) and the operator's HTTP loop
(``--serve``). ``bench`` runs the benchmark configurations of
:mod:`i3dr_stereo_tpu_torch.bench` (one JSON line each; exit code 1 if
any failed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _add_matcher_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--algorithm", default="SGBM",
                   choices=["BM", "SGBM", "I3DRSGM", "BM_GPU", "BP_GPU", "CSBP_GPU"])
    p.add_argument("--min-disparity", type=int, default=0)
    p.add_argument("--disparity-range", type=int, default=64)
    p.add_argument("--window-size", type=int, default=9)
    p.add_argument("--p1", type=float, default=200.0)
    p.add_argument("--p2", type=float, default=400.0)
    p.add_argument("--uniqueness-ratio", type=float, default=15.0)
    p.add_argument("--speckle-size", type=int, default=100)
    p.add_argument("--speckle-range", type=float, default=4.0)
    p.add_argument("--interp", action="store_true")
    p.add_argument("--depth-max", type=float, default=10.0)
    p.add_argument("--depth-min", type=float, default=0.0)
    p.add_argument("--calibration-left", default=None,
                   help="ROS calibration YAML for the left camera")
    p.add_argument("--calibration-right", default=None)
    p.add_argument("--baseline", type=float, default=0.3,
                   help="synthetic-rig baseline (no calibration files)")
    p.add_argument("--fx", type=float, default=1000.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to match on (cuda: the card's "
                        "kernels; cpu: their plain torch twins)")


def _build(args, width, height):
    from i3dr_stereo_tpu_torch.config.params import (
        ALGORITHM_DEFAULTS, Algorithm, PointCloudConfig)
    from i3dr_stereo_tpu_torch.core.camera import StereoRig
    from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline

    algo = Algorithm[args.algorithm]
    cfg = ALGORITHM_DEFAULTS[algo].replace(
        algorithm=algo, min_disparity=args.min_disparity,
        disparity_range=args.disparity_range, window_size=args.window_size,
        p1=args.p1, p2=args.p2, uniqueness_ratio=args.uniqueness_ratio,
        speckle_size=args.speckle_size, speckle_range=args.speckle_range,
        interp=args.interp)
    if args.calibration_left and args.calibration_right:
        rig = StereoRig.from_yaml(args.calibration_left, args.calibration_right)
        rectify = True
    else:
        rig = StereoRig.synthetic(width, height, fx=args.fx,
                                  baseline_m=args.baseline)
        rectify = False
    pipe = StereoPipeline(
        rig=rig, config=cfg,
        cloud=PointCloudConfig(depth_max=args.depth_max, depth_min=args.depth_min),
        device=args.device, rectify_inputs=rectify)
    return pipe


def cmd_match(args) -> int:
    import cv2

    from i3dr_stereo_tpu_torch.io.savers import save_disparity_png, save_ply, save_png
    from i3dr_stereo_tpu_torch.ops.depth import pointcloud_to_numpy
    from i3dr_stereo_tpu_torch.viz.colormap import disparity_to_color

    left = cv2.imread(args.left, cv2.IMREAD_GRAYSCALE)
    right = cv2.imread(args.right, cv2.IMREAD_GRAYSCALE)
    if left is None or right is None:
        print(f"cannot read {args.left} / {args.right}", file=sys.stderr)
        return 2
    pipe = _build(args, left.shape[1], left.shape[0])
    res = pipe.process(left.astype(np.float32), right.astype(np.float32))
    os.makedirs(args.output, exist_ok=True)
    d = res.disparity.cpu().numpy()
    v = res.valid.cpu().numpy()
    save_disparity_png(os.path.join(args.output, "disparity16.png"), d, v)
    save_png(os.path.join(args.output, "disparity_color.png"),
             disparity_to_color(d, v)[..., ::-1])
    if res.depth is not None:
        np.save(os.path.join(args.output, "depth.npy"), res.depth.cpu().numpy())
    if res.points is not None:
        xyz, rgb = pointcloud_to_numpy(res.points)
        save_ply(os.path.join(args.output, "points.ply"), xyz, rgb)
    print(json.dumps({
        "valid_fraction": float(v.mean()),
        "median_disparity": float(np.median(d[v])) if v.any() else None,
        "output": args.output,
    }))
    return 0


def cmd_replay(args) -> int:
    from i3dr_stereo_tpu_torch.bridge.launch import launch_replay
    from i3dr_stereo_tpu_torch.config.params import Algorithm
    from i3dr_stereo_tpu_torch.core.camera import StereoRig
    from i3dr_stereo_tpu_torch.utils.metrics import FPSMeter

    import cv2
    probe = None
    for f in sorted(os.listdir(args.directory)):
        if f.endswith(".png"):
            probe = cv2.imread(os.path.join(args.directory, f),
                               cv2.IMREAD_GRAYSCALE)
            break
    if probe is None:
        print("no frames found", file=sys.stderr)
        return 2
    rig = StereoRig.synthetic(probe.shape[1], probe.shape[0], fx=args.fx,
                              baseline_m=args.baseline)
    lg, run = launch_replay(rig, args.directory,
                            stereo_algorithm=Algorithm[args.algorithm],
                            rate=args.rate,
                            rectify_inputs=False, device=args.device)
    meter = FPSMeter()
    n = 0
    for _ in run:
        meter.tick()
        n += 1
    node = lg.node("generate_disparity")
    print(json.dumps({"frames": n, "processed": node.frames_processed,
                      "dropped": node.frames_dropped,
                      "fps": round(meter.fps, 2)}))
    return 0


def cmd_live(args) -> int:
    from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_camera, run_source
    from i3dr_stereo_tpu_torch.config.params import Algorithm
    from i3dr_stereo_tpu_torch.core.camera import StereoRig
    from i3dr_stereo_tpu_torch.io.sources import SyntheticStereoSource
    from i3dr_stereo_tpu_torch.viz.viewer import StereoViewer

    if args.gige:
        # real hardware: two GigE Vision cameras, full protocol bring-up
        # (the reference's stereo_capture.launch cameras); address form
        # HOST:PORT,HOST:PORT. The left camera's calibration comes from
        # --calib YAMLs when given, else a synthetic rig of the same size.
        from i3dr_stereo_tpu_torch.io.gige import GigEStereoSource

        def addr(s):
            host, _, port = s.partition(":")
            return (host, int(port or 3956))

        left_a, _, right_a = args.gige.partition(",")
        src = GigEStereoSource(addr(left_a), addr(right_a),
                               width=args.width, height=args.height,
                               packet_size=args.packet_size,
                               backend=args.gige_backend)
    else:
        src = SyntheticStereoSource(width=args.width, height=args.height,
                                    n_frames=args.frames)
    try:
        if args.calib:
            rig = StereoRig.from_yaml(*args.calib)
        else:
            rig = StereoRig.synthetic(args.width, args.height, fx=args.fx,
                                      baseline_m=args.baseline)
        lg = launch_stereo_camera(rig,
                                  stereo_algorithm=Algorithm[args.algorithm],
                                  source=src, rectify_inputs=False,
                                  device=args.device)
        viewer = StereoViewer(lg.graph, "/stereo")
        out = {}
        if args.serve:
            out["served"], frames = _serve(args, lg, viewer)
        else:
            frames = run_source(lg)
        out.update({"frames": frames,
                    "processed": lg.node("generate_disparity")
                    .frames_processed})
        if args.save_view:
            out["view"] = viewer.save(args.save_view)
    finally:
        if args.gige:
            src.close()
    print(json.dumps(out))
    return 0


def _serve(args, lg, viewer) -> tuple:
    """The operator loop (stereo_gui + rqt_reconfigure analog): serve the
    node's reconfigure servers and the live montage over HTTP while a
    thread feeds the graph; every frame runs the config current at its
    start. Returns the server's URL and the frames fed."""
    import threading
    import time

    from i3dr_stereo_tpu_torch.bridge.launch import run_source
    from i3dr_stereo_tpu_torch.viz.serve import OperatorServer, make_view_server

    node = lg.node("generate_disparity")
    srv = OperatorServer(viewer.render,
                         {"disparity": node.disparity_cfg,
                          "cloud": node.cloud_cfg,
                          "view": make_view_server(viewer)},
                         port=args.port).start()
    print(json.dumps({"serving": srv.url}), flush=True)
    stop = threading.Event()
    fed = [0]

    def feed():
        while not stop.is_set():
            fed[0] += run_source(lg, stop=stop)  # pairs() restarts a sweep
            if args.duration <= 0:
                break

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        if args.duration > 0:
            time.sleep(args.duration)
        else:
            t.join()
    except KeyboardInterrupt:
        pass
    stop.set()
    t.join()                    # the pair in flight ends the feed
    srv.close()
    return srv.url, fed[0]


def cmd_calibrate(args) -> int:
    import glob

    import cv2

    from i3dr_stereo_tpu_torch.io.calib_store import CalibrationStore
    from i3dr_stereo_tpu_torch.io.calibrate import ChessboardSpec, calibrate_stereo

    lefts = [cv2.imread(p, cv2.IMREAD_GRAYSCALE)
             for p in sorted(glob.glob(os.path.join(args.directory, "l_*.png")))]
    rights = [cv2.imread(p, cv2.IMREAD_GRAYSCALE)
              for p in sorted(glob.glob(os.path.join(args.directory, "r_*.png")))]
    if not lefts or len(lefts) != len(rights):
        print("need matching l_*.png / r_*.png views", file=sys.stderr)
        return 2
    board = ChessboardSpec(cols=args.cols, rows=args.rows,
                           square_size=args.square)
    rig, diag = calibrate_stereo(lefts, rights, board)
    store = CalibrationStore(args.store)
    paths = store.save_rig(args.name, rig)
    print(json.dumps({**diag, "saved": paths}))
    return 0


def cmd_bench(args) -> int:
    from i3dr_stereo_tpu_torch import bench

    return bench.run(args.config, device=args.device)


def cmd_info(args) -> int:
    import torch

    import i3dr_stereo_tpu_torch

    print(json.dumps({
        "version": i3dr_stereo_tpu_torch.__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="i3dr_stereo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("match", help="match one stereo pair from files")
    p.add_argument("left")
    p.add_argument("right")
    p.add_argument("-o", "--output", default="out")
    _add_matcher_args(p)
    p.set_defaults(fn=cmd_match)

    p = sub.add_parser("replay", help="replay a recorded directory")
    p.add_argument("directory")
    p.add_argument("-r", "--rate", type=float, default=0.0,
                   help="clock-paced replay at this multiple of recorded "
                        "time (rosbag play -r; 0 = as fast as possible)")
    _add_matcher_args(p)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("live", help="run the live graph (synthetic source, "
                       "or two GigE Vision cameras with --gige)")
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--save-view", default=None)
    p.add_argument("--serve", action="store_true",
                   help="serve the operator loop over HTTP: MJPEG live "
                        "view + reconfigure panel (stereo_gui + "
                        "rqt_reconfigure analog)")
    p.add_argument("--port", type=int, default=0,
                   help="HTTP port for --serve (0 = ephemeral)")
    p.add_argument("--duration", type=float, default=0.0,
                   help="with --serve: loop the source and serve for this "
                        "many seconds (0 = one pass over --frames)")
    p.add_argument("--gige", default=None, metavar="L_HOST:PORT,R_HOST:PORT",
                   help="capture from two real GigE Vision cameras "
                        "instead of the synthetic source (SDK-free "
                        "GVCP/GVSP driver; port defaults to 3956)")
    p.add_argument("--gige-backend", default="auto",
                   choices=["auto", "python", "native"],
                   help="GVSP reassembly backend (native = C++ engine)")
    p.add_argument("--packet-size", type=int, default=2996,
                   help="with --gige: the GVSP packet size to ask the "
                        "cameras for (SCPS; 2996 suits an MTU of 3000, "
                        "8996 one of 9000)")
    p.add_argument("--calib", nargs=2, default=None,
                   metavar=("LEFT_YAML", "RIGHT_YAML"),
                   help="ROS calibration YAMLs for the rig (default: "
                        "synthetic ideal rig of --width/--height)")
    _add_matcher_args(p)
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("info", help="print environment info")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("calibrate", help="stereo-calibrate from chessboard images")
    p.add_argument("directory", help="dir with l_*.png / r_*.png chessboard views")
    p.add_argument("--cols", type=int, default=9)
    p.add_argument("--rows", type=int, default=6)
    p.add_argument("--square", type=float, default=0.025)
    p.add_argument("--name", default="stereo")
    p.add_argument("--store", default=None, help="calibration store directory")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("bench", help="run benchmark configurations (one "
                       "JSON line each)")
    p.add_argument("--config", default="flagship",
                   help="flagship, e2e_2448, flagship_flat, sgbm_1280, "
                        "bm_640, pipeline_batch, sgm_direct_2448, stages, "
                        "or all")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda: the card's kernels; cpu: "
                        "their plain torch twins)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
