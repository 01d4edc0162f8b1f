"""Live interactive world viewer (port of fpv4d/vis/interactive.py).

A tiny HTTP server stands in for the windowed event loop: the browser
is the display surface, frames are rendered on demand on the model's
device by world_view.render_frame and encoded by vis/png.py, and the
play loop and camera state live server-side per request: play/pause,
scrubbing, mode switching (fixed / follow / orbit) and mouse-drag
orbiting. Works over an SSH port-forward.

Usage:
    python -m fpv4d_torch.cli.vis interactive FITTING_DIR --scene scene.ply
then open http://localhost:8089/.
"""
from __future__ import annotations

import glob
import json
import os
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from fpv4d_torch.io import body_pkl
from fpv4d_torch.vis import world_view as WV
from fpv4d_torch.vis.png import encode_png

_PAGE = """<!doctype html>
<html><head><title>fpv4d interactive viewer</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
#view { cursor:grab; border:1px solid #444 }
#bar { margin:0.5em 0 } input[type=range] { width:420px }
</style></head><body>
<div>fpv4d world viewer &mdash; space: play/pause &middot;
&larr;/&rarr;: scrub &middot; f: fixed &middot; c: follow &middot;
o: orbit &middot; drag: orbit camera &middot; wheel: zoom</div>
<div id="bar"><input type="range" id="scrub" min="0" max="0" value="0">
<span id="info"></span></div>
<img id="view" width="1280" height="720">
<script>
let N=1, i=0, playing=true, mode="orbit", az=0.0, el=0.35, zoom=1.0;
let busy=false, drag=null;
const img=document.getElementById("view"),
      scrub=document.getElementById("scrub"),
      info=document.getElementById("info");
fetch("meta").then(r=>r.json()).then(m=>{N=m.num_frames;
  scrub.max=N-1; tick();});
function url(){return `frame?i=${i}&mode=${mode}&azim=${az.toFixed(3)}`+
  `&elev=${el.toFixed(3)}&zoom=${zoom.toFixed(3)}`;}
function tick(){ if(busy) return; busy=true;
  const want=url();
  fetch(want).then(r=>r.blob()).then(b=>{
    // revoke the previous frame's blob URL — hours of playback would
    // otherwise pin every fetched PNG in the tab for the page's life
    if(img.src.startsWith("blob:")) URL.revokeObjectURL(img.src);
    img.src=URL.createObjectURL(b); busy=false;
    info.textContent=`frame ${i+1}/${N} [${mode}]`;
    scrub.value=i;
    if(playing){ i=(i+1)%N; if(mode=="orbit") az+=2*Math.PI/N; }
  }).catch(()=>{busy=false;});
  az%=2*Math.PI;   // keep orbit keys periodic so replays hit the memo
}
setInterval(()=>{ if(playing||img.src=="") tick(); }, 120);
document.addEventListener("keydown",e=>{
  if(e.key==" "){playing=!playing; e.preventDefault();}
  else if(e.key=="ArrowRight"){i=(i+1)%N; tick();}
  else if(e.key=="ArrowLeft"){i=(i-1+N)%N; tick();}
  else if(e.key=="f"){mode="fixed"; tick();}
  else if(e.key=="c"){mode="follow"; tick();}
  else if(e.key=="o"){mode="orbit"; tick();}
});
scrub.addEventListener("input",()=>{i=+scrub.value; tick();});
img.addEventListener("mousedown",e=>{drag=[e.clientX,e.clientY];});
window.addEventListener("mouseup",()=>{drag=null;});
window.addEventListener("mousemove",e=>{ if(!drag) return;
  az+=(e.clientX-drag[0])*0.01; el+=(e.clientY-drag[1])*0.005;
  el=Math.max(-1.2,Math.min(1.4,el)); drag=[e.clientX,e.clientY];
  mode="orbit"; tick();});
img.addEventListener("wheel",e=>{ zoom*=Math.exp(e.deltaY*0.001);
  zoom=Math.max(0.3,Math.min(4,zoom)); mode="orbit"; tick();
  e.preventDefault();});
</script></body></html>
"""


class InteractiveViewer:
    """Server-side state + renderer behind the HTTP event loop.

    Renders lazily per request and memoizes the PNG by the full
    camera/frame key in an LRU of 512 entries, so pausing on a frame or
    replaying a loop costs one render.
    """

    def __init__(self, fitting_dir: str, model, vposer_params,
                 scene_pts, limit: Optional[int] = None):
        self.model = model
        self.vp = vposer_params
        dev = model.v_template.device
        self.scene = torch.as_tensor(np.asarray(scene_pts, np.float32),
                                     device=dev)
        pkls = sorted(glob.glob(os.path.join(fitting_dir,
                                             "*.pkl")))[:limit]
        if not pkls:
            raise FileNotFoundError(
                f"no .pkl frames under {fitting_dir}")
        self.params: List[Dict] = [body_pkl.load_frame(p)
                                   for p in pkls]
        self.cams = torch.as_tensor(np.stack(
            [np.asarray(p.get("camera_ext", np.eye(4)), np.float32)
             for p in self.params]), device=dev)
        centers = torch.stack([WV.body_to_world(p, dev)[:3, 3]
                               for p in self.params])
        self.center = centers.mean(0)
        self.radius = float(max(2.5, 1.8 * float(torch.linalg.vector_norm(
            centers - self.center, dim=1).max())))
        self.trajectory = self.cams[:, :3, 3]
        # a long-open viewer with drag/zoom interaction generates
        # unboundedly many camera keys: cap the PNG cache
        self._cache: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._cache_cap = 512
        self._lock = threading.Lock()

    @property
    def num_frames(self) -> int:
        return len(self.params)

    def render_png(self, i: int, mode: str = "orbit",
                   azim: float = 0.0, elev: float = 0.35,
                   zoom: float = 1.0) -> bytes:
        i = int(i) % self.num_frames
        key = (i, mode, round(float(azim), 3), round(float(elev), 3),
               round(float(zoom), 3))
        with self._lock:
            png = self._cache.get(key)
            if png is not None:
                self._cache.move_to_end(key)
                return png
        if mode == "fixed":
            view = self.cams[0]
        elif mode == "follow":
            view = self.cams[i]
        else:
            view = WV.orbit_view(self.center,
                                 self.radius * float(zoom),
                                 float(azim), float(elev))
        img = WV.render_frame(self.model, self.vp, self.params[i],
                              self.scene, view,
                              self.trajectory[:i + 1])
        png = encode_png((torch.clamp(img, 0, 1) * 255).to(torch.uint8))
        with self._lock:
            self._cache[key] = png
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return png


def make_server(viewer: InteractiveViewer, port: int = 8089,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """HTTP server wrapping the viewer; caller owns serve_forever()/
    shutdown() (the CLI runs it in the foreground, tests in a
    thread)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):       # noqa: N802 (http.server API)
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                if u.path in ("/", "/index.html"):
                    self._send(200, "text/html",
                               _PAGE.encode("utf-8"))
                elif u.path == "/meta":
                    self._send(200, "application/json", json.dumps(
                        {"num_frames": viewer.num_frames}).encode())
                elif u.path == "/frame":
                    png = viewer.render_png(
                        int(q.get("i", 0)), q.get("mode", "orbit"),
                        float(q.get("azim", 0.0)),
                        float(q.get("elev", 0.35)),
                        float(q.get("zoom", 1.0)))
                    self._send(200, "image/png", png)
                else:
                    self._send(404, "text/plain", b"not found")
            except Exception as e:      # surface errors to the client
                self._send(500, "text/plain",
                           f"{type(e).__name__}: {e}".encode())

        def log_message(self, *a):      # quiet (the CLI prints once)
            pass

    return ThreadingHTTPServer((host, port), Handler)
