"""The operator loop: live view + live tuning over plain HTTP.

The reference binds rqt_reconfigure + the Qt/VTK stereo GUI into one
operator workflow — move a P1 slider, watch disparity and the cloud
update (src/stereo_gui.cpp:126-147, launch/stereo_matcher.launch:209).
This module is that loop without a display server: a tiny threaded HTTP
server exposing

- ``/``          — one-page UI: the MJPEG stream + a parameter panel
                   built from the reconfigure schema (sliders/selects
                   posting to /set)
- ``/stream``    — multipart/x-mixed-replace MJPEG of the live montage
                   (raw | rect | disparity | depth | cloud panes)
- ``/frame.jpg`` — single JPEG snapshot
- ``/params``    — JSON: schema + current values of every bound server
- ``/set?name=v``— apply a parameter change (clamped by the schema,
                   routed to the owning ReconfigureServer whose callback
                   updates the running node/pipeline — numeric changes
                   reuse the compiled step, see StereoPipeline.DYN_FIELDS)

Works with any browser or ``curl``; no GUI toolkit, no ROS. Tested by
driving the endpoints in-process (tests/test_viewer_serve.py).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html><title>i3dr_stereo_tpu_torch operator</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;margin:1em}
img{max-width:70vw;border:1px solid #444;cursor:grab;user-select:none}
.panel{display:inline-block;vertical-align:top;margin-left:1em}
label{display:block;margin:4px 0}</style>
<img id="view" src="/stream" draggable="false">
<div class="panel"><h3>parameters</h3><div id="params"></div></div>
<script>
async function load(){
 const r = await fetch('/params'); const d = await r.json();
 const el = document.getElementById('params'); el.innerHTML='';
 for (const [srv, block] of Object.entries(d)){
  const h = document.createElement('h4'); h.textContent = srv; el.appendChild(h);
  for (const p of block.schema){
   const l = document.createElement('label');
   l.textContent = p.name + ' = ' + block.values[p.name] + ' ';
   const i = document.createElement('input'); i.value = block.values[p.name];
   i.size = 6;
   i.onchange = async () => {
     await fetch('/set?server='+srv+'&'+p.name+'='+i.value); load(); };
   l.appendChild(i); el.appendChild(l);
  }
 }
 return d;
}
// drag-to-orbit on the montage (the VTK-interactor analog,
// src/stereo_gui.cpp:25): horizontal drag = azimuth, vertical = elevation;
// wheel = zoom. No-ops unless a "view" server is bound.
let vstate = null;
load().then(d => { if (d.view) vstate = {...d.view.values}; });
const img = document.getElementById('view');
let drag = null;
img.onmousedown = e => { drag = [e.clientX, e.clientY]; };
window.onmouseup = () => { drag = null; };
window.onmousemove = async e => {
 if (!drag || !vstate) return;
 const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
 drag = [e.clientX, e.clientY];
 vstate.azim = Math.max(-180, Math.min(180, vstate.azim + dx * 0.5));
 vstate.elev = Math.max(-90, Math.min(90, vstate.elev + dy * 0.5));
 fetch('/set?server=view&azim='+vstate.azim+'&elev='+vstate.elev);
};
img.onwheel = e => {
 if (!vstate) return; e.preventDefault();
 vstate.zoom = Math.max(0.2, Math.min(5,
   vstate.zoom * (e.deltaY < 0 ? 1.1 : 0.9)));
 fetch('/set?server=view&zoom='+vstate.zoom);
};
</script>"""


def make_view_server(viewer):
    """A reconfigure server steering the cloud pane's orbit camera — the
    operator-facing analog of the reference GUI's VTK interactor
    (src/stereo_gui.cpp:25) and the rviz scene viewpoints. Binds to a
    :class:`~i3dr_stereo_tpu_torch.viz.viewer.StereoViewer`; expose it as the
    ``view`` server so the page's drag-to-orbit JS finds it."""
    from i3dr_stereo_tpu_torch.bridge.reconfigure import ParamDesc, ReconfigureServer
    from i3dr_stereo_tpu_torch.viz.cloud import VIEWPOINTS

    names = list(VIEWPOINTS)
    schema = [
        ParamDesc("preset", "enum", 0, 0, len(names) - 1,
                  {n: i for i, n in enumerate(names)}, "canned viewpoint"),
        ParamDesc("elev", "double", viewer.cloud_elev, -90.0, 90.0,
                  None, "orbit elevation, degrees"),
        ParamDesc("azim", "double", viewer.cloud_azim, -180.0, 180.0,
                  None, "orbit azimuth, degrees"),
        ParamDesc("zoom", "double", 1.0, 0.2, 5.0, None, "dolly factor"),
        ParamDesc("point_size", "int", 2, 1, 9, None, "splat size, px"),
    ]

    srv = ReconfigureServer(schema, None)

    def on_change(values, changed):
        if "preset" in changed:
            # preset selection writes the angles back into the server so
            # the panel (and the drag JS state) see the new orientation
            e, a = VIEWPOINTS[names[values["preset"]]]
            srv.values["elev"], srv.values["azim"] = e, a
        viewer.cloud_elev = srv.values["elev"]
        viewer.cloud_azim = srv.values["azim"]
        viewer.cloud_zoom = srv.values["zoom"]
        viewer.cloud_point_size = srv.values["point_size"]

    srv._cb = on_change
    return srv


class OperatorServer:
    """Serve a live render callable + reconfigure servers over HTTP.

    ``render`` returns the current RGB uint8 montage (or None before the
    first frame). ``servers`` maps a name (e.g. "disparity", "cloud") to
    a :class:`~i3dr_stereo_tpu_torch.bridge.reconfigure.ReconfigureServer`.
    """

    def __init__(self, render: Callable[[], Optional[np.ndarray]],
                 servers: Dict[str, object], *, host: str = "127.0.0.1",
                 port: int = 0, stream_fps: float = 10.0):
        self.render = render
        self.servers = servers
        self.stream_fps = stream_fps
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib API)
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/params":
                    out = {}
                    for name, srv in outer.servers.items():
                        out[name] = {
                            "schema": [{"name": d.name, "type": d.type,
                                        "min": d.min, "max": d.max}
                                       for d in srv.describe()],
                            "values": srv.get()}
                    self._json(out)
                elif u.path == "/set":
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    srv_name = q.pop("server", None)
                    try:
                        applied = outer.apply(q, server=srv_name)
                        self._json({"ok": True, "values": applied})
                    except KeyError as e:
                        self._json({"ok": False, "error": str(e)}, 400)
                elif u.path == "/frame.jpg":
                    jpg = outer._jpeg()
                    if jpg is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpg)))
                    self.end_headers()
                    self.wfile.write(jpg)
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while not outer._stop.is_set():
                            jpg = outer._jpeg()
                            if jpg is not None:
                                self.wfile.write(b"--frame\r\n")
                                self.wfile.write(
                                    b"Content-Type: image/jpeg\r\n")
                                self.wfile.write(
                                    f"Content-Length: {len(jpg)}\r\n\r\n"
                                    .encode())
                                self.wfile.write(jpg)
                                self.wfile.write(b"\r\n")
                            time.sleep(1.0 / outer.stream_fps)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        self._stop = threading.Event()
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    # -- parameter routing ------------------------------------------------

    def apply(self, flat: Dict[str, str], server: Optional[str] = None
              ) -> Dict[str, object]:
        """Apply string-valued updates: route each key to the named
        server, or to whichever bound server's schema owns it."""
        applied: Dict[str, object] = {}
        for key, raw in flat.items():
            owners = ([self.servers[server]] if server
                      else [s for s in self.servers.values()
                            if key in s.schema])
            if not owners or (server and key not in owners[0].schema):
                raise KeyError(f"unknown parameter {key!r}")
            srv = owners[0]
            desc = srv.schema[key]
            val: object = raw
            if desc.type in ("int", "enum"):
                val = int(float(raw))
            elif desc.type == "double":
                val = float(raw)
            elif desc.type == "bool":
                val = str(raw).lower() in ("1", "true", "on", "yes")
            applied.update(srv.update(**{key: val}))
        return applied

    def _jpeg(self) -> Optional[bytes]:
        img = self.render()
        if img is None:
            return None
        import cv2

        ok, buf = cv2.imencode(".jpg", np.asarray(img)[..., ::-1],
                               [int(cv2.IMWRITE_JPEG_QUALITY), 85])
        return buf.tobytes() if ok else None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "OperatorServer":
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=2)
