"""Live avatar viewer: a small HTTP server rendering the current gaussians
(port of gaussianip_tpu/utils/viewer.py).

GET /render?azimuth=30&elevation=10&radius=1.8&size=512 returns a PNG of
the current state, rendered on the state's device (K1 on the card) from an
orbit camera (z up, fovy 0.9, black background, RenderConfig() defaults);
GET / returns a minimal orbit-viewer page. `ViewerState.update(gaussians)`
swaps the state under a lock from the training loop. The PNG comes from
the port's own encoder (utils/saving.encode_png)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html><title>gaussianip-tpu viewer</title>
<body style="margin:0;background:#111;color:#eee;font-family:monospace">
<div style="padding:8px">azimuth <input id=a type=range min=-180 max=180 value=0>
elevation <input id=e type=range min=-89 max=89 value=5>
radius <input id=r type=range min=5 max=40 value=18></div>
<img id=v width=512 height=512>
<script>
const v=document.getElementById('v');
function refresh(){v.src='/render?azimuth='+a.value+'&elevation='+e.value+
'&radius='+(r.value/10)+'&t='+Date.now();}
for (const el of [a,e,r]) el.oninput=refresh;
setInterval(refresh, 2000); refresh();
</script></body>"""

FOVY = 0.9


def orbit_camera(azimuth: float, elevation: float, radius: float, size: int,
                 device):
    """The viewer's [1] camera: eye on a z-up sphere around the origin."""
    import torch

    from ..data.cameras import camera_from_c2w
    from ..ops.camera_math import look_at_c2w

    el, az = np.deg2rad(elevation), np.deg2rad(azimuth)
    eye = radius * np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    f32 = dict(dtype=torch.float32, device=device)
    c2w = look_at_c2w(torch.as_tensor(eye, **f32)[None],
                      torch.zeros((1, 3), **f32),
                      torch.tensor([[0.0, 0, 1]], **f32))
    return camera_from_c2w(c2w, torch.full((1,), FOVY, **f32), size, size)


class ViewerState:
    def __init__(self):
        self.lock = threading.Lock()
        self.gaussians = None

    def update(self, gaussians):
        with self.lock:
            self.gaussians = gaussians

    def render(self, azimuth, elevation, radius, size) -> np.ndarray:
        """[size, size, 3] uint8 (zeros before the first update)."""
        import torch

        from ..render.render import RenderConfig, render

        with self.lock:
            g = self.gaussians
        if g is None:
            return np.zeros((size, size, 3), np.uint8)
        cams = orbit_camera(azimuth, elevation, radius, size, g.device)
        with torch.no_grad():
            out = render(g, cams, torch.zeros(3, device=g.device),
                         RenderConfig())
        return (out.rgb[0].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def start_viewer(state: ViewerState, host: str = "127.0.0.1",
                 port: int = 6009):
    """Serve `state` from a daemon thread; returns the server (call its
    shutdown() to stop). Port 0 picks a free port
    (server.server_address[1])."""
    from .saving import encode_png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/render":
                q = parse_qs(u.query)

                def f(name, default):
                    return float(q.get(name, [default])[0])

                img = state.render(f("azimuth", 0), f("elevation", 5),
                                   f("radius", 1.8), int(f("size", 512)))
                self._send(encode_png(img), "image/png")
            else:
                self._send(_PAGE.encode(), "text/html")

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
