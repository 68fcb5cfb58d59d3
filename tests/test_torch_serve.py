"""Torch port of the operator loop over HTTP (``viz/serve.py``, a copy
pinned to its original by ``tests/test_torch_shell_nodes.py``) and ``cli
live --serve``, on the CPU: the live montage and the reconfigure panel
bound to a running graph, as the reference's tests/test_viewer_serve.py
drives them, the same requests answered as the reference's server
answers them, and a ``/set`` of P1 reaching the next frame."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from i3dr_stereo_tpu_torch.bridge.launch import launch_stereo_camera, run_source
from i3dr_stereo_tpu_torch.config.params import ALGORITHM_DEFAULTS, Algorithm
from i3dr_stereo_tpu_torch.core.camera import StereoRig
from i3dr_stereo_tpu_torch.io.sources import SyntheticStereoSource
from i3dr_stereo_tpu_torch.pipeline.stereo_pipeline import StereoPipeline
from i3dr_stereo_tpu_torch.viz.serve import OperatorServer, make_view_server
from i3dr_stereo_tpu_torch.viz.viewer import StereoViewer

torch.set_num_threads(2)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _status(url):
    """(HTTP status, the JSON body or None) of a request that may fail."""
    try:
        return _get(url)[0], None
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body) if body else None


def _graph(n_frames=2):
    src = SyntheticStereoSource(width=96, height=80, n_frames=n_frames,
                                max_disp=12)
    rig = StereoRig.synthetic(96, 80, fx=100.0)
    cfg = ALGORITHM_DEFAULTS[Algorithm.SGBM].replace(disparity_range=16,
                                                     speckle_size=0)
    lg = launch_stereo_camera(rig, stereo_algorithm=Algorithm.SGBM,
                              source=src, rectify_inputs=False,
                              config=cfg, warmup=False, device="cpu")
    return lg, StereoViewer(lg.graph, "/stereo"), lg.node("generate_disparity")


def test_operator_server_answers_as_the_reference():
    """The two packages' servers over the same reconfigure servers (the
    node's schemas, seeded alike) answer ``/params`` and every ``/set``
    alike, a clamped value and an unknown parameter included."""
    from i3dr_stereo_tpu.bridge import reconfigure as ref_rc
    from i3dr_stereo_tpu.viz.serve import OperatorServer as RefServer
    from i3dr_stereo_tpu_torch.bridge import reconfigure as rc

    seen = {"port": [], "ref": []}
    servers = {}
    for name, mod, cls in (("port", rc, OperatorServer),
                           ("ref", ref_rc, RefServer)):
        bound = {"disparity": mod.ReconfigureServer(
                     mod.DISPARITY_SCHEMA,
                     lambda flat, ch, n=name: seen[n].append(sorted(ch)),
                     initial={"p1": 0.1, "p2": 0.8, "disparity_range": 256}),
                 "cloud": mod.ReconfigureServer(mod.POINTCLOUD_SCHEMA)}
        servers[name] = cls(lambda: None, bound).start()
    try:
        answers = {}
        for name, srv in servers.items():
            u = srv.url
            answers[name] = [
                json.loads(_get(u + "params")[2]),
                json.loads(_get(u + "set?server=disparity&p1=0.4")[2]),
                json.loads(_get(u + "set?p2=99999&depth_max=7.5")[2]),
                _status(u + "set?server=disparity&bogus=1"),
                _status(u + "set?server=cloud&p1=1"),
                _status(u + "frame.jpg"),
                _status(u + "nowhere")]
        assert answers["port"] == answers["ref"]
        assert answers["port"][1]["values"]["p1"] == 0.4
        assert answers["port"][3][0] == 400
        assert answers["port"][5:] == [(503, None), (404, None)]
        assert seen["port"] == seen["ref"] == [["p1"], ["p2"]]
    finally:
        for srv in servers.values():
            srv.close()


def test_operator_server_end_to_end():
    lg, viewer, node = _graph()
    run_source(lg)  # produce frames so the montage exists
    srv = OperatorServer(viewer.render,
                         {"disparity": node.disparity_cfg,
                          "cloud": node.cloud_cfg}).start()
    try:
        status, ctype, body = _get(srv.url)
        assert status == 200 and b"/stream" in body
        status, ctype, body = _get(srv.url + "frame.jpg")
        assert status == 200 and ctype == "image/jpeg" and len(body) > 1000

        # params reflect the node's current values (seeded, not defaults)
        params = json.loads(_get(srv.url + "params")[2])
        assert set(params) == {"disparity", "cloud"}
        assert params["disparity"]["values"]["disparity_range"] == 16

        # live tuning through the HTTP path reaches the running pipeline
        before = node.pipeline.config.p2
        status, _, body = _get(srv.url + "set?server=disparity&p2=1234")
        assert status == 200 and json.loads(body)["ok"]
        assert node.pipeline.config.p2 == 1234.0 != before
        processed = node.frames_processed
        run_source(lg)
        assert node.frames_processed == processed + 2

        # unknown parameter -> clean 4xx, not a crash
        assert _status(srv.url + "set?server=disparity&bogus=1")[0] == 400

        # the MJPEG stream yields at least one JPEG part
        req = urllib.request.urlopen(srv.url + "stream", timeout=10)
        chunk = req.read(20000)
        req.close()
        assert b"--frame" in chunk and b"image/jpeg" in chunk
    finally:
        srv.close()


def test_set_p1_reaches_the_next_frame():
    """A ``/set`` of P1 between two frames: the next frame's disparity is
    ``process``'s under a config with that P1, and not the old one's."""
    lg, viewer, node = _graph(n_frames=1)
    pubs, raw = [], {}
    lg.graph.subscribe("/stereo/disparity", lambda s, m: pubs.append(m))
    for side in ("left", "right"):
        lg.graph.subscribe(f"/stereo/{side}/image_raw",
                           lambda s, d, side=side: raw.__setitem__(side, d))
    srv = OperatorServer(viewer.render,
                         {"disparity": node.disparity_cfg}).start()
    try:
        run_source(lg)
        old = node.pipeline.config
        body = json.loads(_get(srv.url + "set?server=disparity&p1=20")[2])
        assert body["ok"] and body["values"]["p1"] == 20.0
        run_source(lg)
    finally:
        srv.close()
    assert len(pubs) == 2 and node.pipeline.config.p1 == 20.0 != old.p1
    rig, cloud = node.pipeline.rig, node.pipeline.cloud
    want, was = (StereoPipeline(rig, cfg, cloud, device="cpu",
                                rectify_inputs=False)
                 .process(raw["left"], raw["right"])
                 for cfg in (node.pipeline.config, old))
    np.testing.assert_array_equal(pubs[1]["disparity"], want.disparity.numpy())
    np.testing.assert_array_equal(pubs[1]["valid"], want.valid.numpy())
    np.testing.assert_array_equal(pubs[0]["disparity"], was.disparity.numpy())
    assert not np.array_equal(pubs[1]["disparity"], was.disparity.numpy())


def test_view_server_steers_cloud_pane():
    lg, viewer, node = _graph(n_frames=1)
    run_source(lg)
    srv = OperatorServer(viewer.render,
                         {"disparity": node.disparity_cfg,
                          "view": make_view_server(viewer)}).start()
    try:
        params = json.loads(_get(srv.url + "params")[2])
        names = {d["name"] for d in params["view"]["schema"]}
        assert {"preset", "elev", "azim", "zoom", "point_size"} <= names

        _get(srv.url + "set?server=view&elev=42.5&azim=-10")
        assert viewer.cloud_elev == 42.5 and viewer.cloud_azim == -10.0

        _get(srv.url + "set?server=view&preset=3")      # top_down
        assert (viewer.cloud_elev, viewer.cloud_azim) == (75.0, 0.0)
        vals = json.loads(_get(srv.url + "params")[2])["view"]["values"]
        assert vals["elev"] == 75.0

        _get(srv.url + "set?server=view&zoom=2.0&point_size=4")
        assert viewer.cloud_zoom == 2.0 and viewer.cloud_point_size == 4
        img1 = viewer.render()
        assert img1 is not None and img1.size > 0

        _get(srv.url + "set?server=view&elev=0&azim=0&zoom=1.0")
        assert not np.array_equal(img1, viewer.render())

        _, _, page = _get(srv.url)
        assert b"onmousedown" in page and b"server=view" in page
    finally:
        srv.close()


def test_cli_live_serve(capsys):
    from i3dr_stereo_tpu_torch.cli import main

    rc = main(["live", "--frames", "2", "--width", "96", "--height", "80",
               "--serve", "--algorithm", "BM", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    first, last = json.loads(out[0]), json.loads(out[-1])
    assert first["serving"].startswith("http://")
    assert last["processed"] == last["frames"] == 2 and "served" in last


def test_cli_live_serve_duration(capsys):
    """``--duration``: the source loops while the server answers, and
    the feed ends after the pair in flight once the time is up."""
    from i3dr_stereo_tpu_torch.cli import main

    rc = []
    t = threading.Thread(target=lambda: rc.append(main(
        ["live", "--frames", "2", "--width", "96", "--height", "80",
         "--serve", "--duration", "1.5", "--algorithm", "BM",
         "--device", "cpu"])))
    t.start()
    seen = ""
    deadline = time.monotonic() + 60
    while '"serving"' not in seen and time.monotonic() < deadline:
        time.sleep(0.05)
        seen += capsys.readouterr().out
    url = json.loads(seen.strip().splitlines()[0])["serving"]
    params = json.loads(_get(url + "params")[2])
    assert set(params) == {"disparity", "cloud", "view"}
    t.join(timeout=60)
    assert not t.is_alive() and rc == [0]
    last = json.loads((seen + capsys.readouterr().out).strip()
                      .splitlines()[-1])
    assert last["served"] == url and last["frames"] == last["processed"] >= 2
    with pytest.raises(urllib.error.URLError):
        _get(url + "params", timeout=2)
