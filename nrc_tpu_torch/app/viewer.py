"""Interactive presentation: a stdlib HTTP live viewer.

Port of ``nrc_tpu/app/viewer.py`` (the reference presents through OpenGL,
``Rasterizer::display``, re-uploaded about once a second in
``Application::render``, ``Application.cpp:457-491``, with GLFW mouse
handlers for orbit, pan, dolly and zoom, ``Application::guiEventHandler``,
``Application.cpp:572-648``). A card's host is often headless, so the
display is an embedded ``http.server`` with the JAX package's page and
endpoints: the render loop publishes a tonemapped PNG about once a second,
the page shows it and turns mouse drags and the wheel into the same camera
verbs, which the loop applies between frames (a camera change restarts the
accumulation, ``Application::restartRendering``).

The server's threads touch only bytes and Python values: the loop encodes
the PNG (``utils/image_io.encode_png``) and hands its bytes over; events,
actions and settings cross in queues the loop drains. No CUDA tensor is
read on the server's threads. Over ranks (``--present --devices N``) rank
0 alone serves; the camera verbs are drained as data (``drain_events``) and
applied on every rank by ``apply_camera_events``.

Enabled by ``present 1`` in the system description or ``--present`` on the
CLI (mode 0, ``app/cli.py::_present_loop``).
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

_PAGE = """<!doctype html>
<html><head><title>nrc-tpu</title><style>
body { margin: 0; background: #111; color: #ccc; font: 13px monospace; }
#wrap { display: flex; flex-direction: column; align-items: center; }
img { image-rendering: pixelated; margin-top: 8px; cursor: grab; }
#bar { padding: 6px; }
</style></head><body><div id="wrap">
<div id="bar">drag: orbit &middot; shift-drag: pan &middot; wheel: dolly
&middot; ctrl-wheel: zoom &middot;
<button onclick="fetch('/action?op=screenshot_png')">png [P]</button>
<button onclick="fetch('/action?op=screenshot_hdr')">hdr [H]</button>
<button onclick="fetch('/action?op=save_system')">save system [S]</button>
<button onclick="fetch('/action?op=reset_cache')">reset cache</button>
&middot; <span id="stats"></span></div>
<div id="panel" style="padding:4px 6px; max-width: 760px;">
<!-- render-mode radio + encoding combo + hyperparam sliders: the
     reference's System/Stats ImGui windows (Application.cpp:650-1068) -->
<span id="modes"></span> &middot; encoding
<select id="enc" onchange="setp('encoding', this.value)">
<option>frequency</option><option>hash</option></select>
<br>
lr <input id="lr" type="range" min="-5" max="-1" step="0.1" style="width:110px"
 oninput="setp('learning_rate', Math.pow(10, +this.value)); lrv.textContent=Math.pow(10,+this.value).toExponential(1)">
<span id="lrv"></span>
&middot; unbiased 1/<input id="unb" type="number" min="1" max="64" value="16"
 style="width:40px" onchange="setp('train_unbiased_ratio', 1/+this.value)">
&middot; area spread c <input id="asf" type="number" step="0.005" value="0.01"
 style="width:60px" onchange="setp('area_spread_factor', +this.value)">
<br>
tonemap: gamma <input id="tm_gamma" type="number" step="0.1" style="width:46px"
 onchange="setp('tm_gamma', +this.value)">
white <input id="tm_white" type="number" step="0.1" style="width:46px"
 onchange="setp('tm_white', +this.value)">
burn <input id="tm_burn" type="number" step="0.1" style="width:46px"
 onchange="setp('tm_burn', +this.value)">
crush <input id="tm_crush" type="number" step="0.05" style="width:46px"
 onchange="setp('tm_crush', +this.value)">
sat <input id="tm_sat" type="number" step="0.1" style="width:46px"
 onchange="setp('tm_sat', +this.value)">
bright <input id="tm_bright" type="number" step="0.1" style="width:46px"
 onchange="setp('tm_bright', +this.value)">
<br>
<!-- per-material parameter editors: the Param_info analog
     (inc/MaterialMDL.h:62-295) -->
material <select id="mat" onchange="showMat()"></select>
<span id="matedit"></span>
</div>
<img id="frame" src="/frame.png" draggable="false">
<svg id="lossplot" width="512" height="48" style="margin-top:6px"></svg>
</div><script>
function setp(k, v) { fetch(`/set?key=${k}&value=${encodeURIComponent(v)}`); }
let PARAMS = null;
function showMat() {
  if (!PARAMS) return;
  const m = PARAMS.materials[+document.getElementById('mat').value];
  const e = document.getElementById('matedit');
  const rgb = (v) => v.map(x => (+x).toFixed(3)).join(',');
  e.innerHTML =
    ` albedo <input style="width:110px" value="${rgb(m.albedo)}"
       onchange="setm(${m.index},'albedo',this.value)">` +
    ` rough <input style="width:70px" value="${rgb(m.roughness.slice(0,2))}"
       onchange="setm(${m.index},'roughness',this.value)">` +
    ` ior <input style="width:44px" value="${m.ior}"
       onchange="setm(${m.index},'ior',this.value)">` +
    ` thin <input type="checkbox" ${m.thin_walled ? 'checked' : ''}
       onchange="setm(${m.index},'thin_walled',this.checked?1:0)">` +
    ` emission <input style="width:110px" value="${rgb(m.emission_intensity)}"
       onchange="setm(${m.index},'emission_intensity',this.value)">`;
}
function setm(i, k, v) {
  fetch(`/set?material=${i}&key=${k}&value=${encodeURIComponent(v)}`);
}
fetch('/params').then(r => r.json()).then(p => {
  PARAMS = p;
  const modes = document.getElementById('modes');
  modes.innerHTML = p.render_modes.map(m =>
    `<label><input type="radio" name="rm" value="${m}"
      ${m === p.render_mode ? 'checked' : ''}
      onchange="setp('render_mode', this.value)">${m.toLowerCase()}</label>`
  ).join(' ');
  document.getElementById('enc').value = p.encoding;
  document.getElementById('lr').value = Math.log10(p.learning_rate);
  document.getElementById('lrv').textContent = p.learning_rate.toExponential(1);
  document.getElementById('unb').value = Math.round(1 / p.train_unbiased_ratio);
  document.getElementById('asf').value = p.area_spread_factor;
  for (const [k, v] of Object.entries(p.tonemapper))
    { const el = document.getElementById('tm_' + k); if (el) el.value = v; }
  const sel = document.getElementById('mat');
  sel.innerHTML = p.materials.map((m, i) =>
    `<option value="${i}">${m.name}</option>`).join('');
  showMat();
});
const img = document.getElementById('frame');
const stats = document.getElementById('stats');
let drag = null;
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY, e.shiftKey]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const [x0, y0, pan] = drag;
  const dx = (e.clientX - x0) / img.width, dy = (e.clientY - y0) / img.height;
  drag = [e.clientX, e.clientY, pan];
  fetch(`/control?op=${pan ? 'pan' : 'orbit'}&dx=${dx}&dy=${dy}`);
});
img.addEventListener('wheel', e => {
  e.preventDefault();
  const op = e.ctrlKey ? 'zoom' : 'dolly';
  fetch(`/control?op=${op}&d=${e.deltaY > 0 ? -1 : 1}`);
}, { passive: false });
// reference key handlers (Application::guiEventHandler): P/H screenshots,
// S save system description
window.addEventListener('keydown', e => {
  const map = { p: 'screenshot_png', h: 'screenshot_hdr', s: 'save_system' };
  const op = map[e.key.toLowerCase()];
  if (op) fetch(`/action?op=${op}`);
});
const plot = document.getElementById('lossplot');
setInterval(() => {
  img.src = '/frame.png?t=' + Date.now();
  fetch('/stats').then(r => r.json()).then(s => {
    stats.textContent =
      `spp ${s.iteration} | ${s.fps.toFixed(2)} fps | loss ${s.loss.toFixed(4)}`;
    // 256-frame loss sparkline (the reference Stats window plot)
    const h = s.loss_history || [];
    if (h.length > 1) {
      const w = 512, ht = 48, mx = Math.max(...h), mn = Math.min(...h);
      const pts = h.map((v, i) =>
        `${(i / (h.length - 1) * w).toFixed(1)},` +
        `${(ht - 2 - (v - mn) / Math.max(mx - mn, 1e-9) * (ht - 4)).toFixed(1)}`
      ).join(' ');
      plot.innerHTML =
        `<polyline points="${pts}" fill="none" stroke="#6cf" stroke-width="1"/>` +
        `<text x="2" y="10" fill="#888" font-size="9">${mx.toFixed(3)}</text>` +
        `<text x="2" y="${ht - 2}" fill="#888" font-size="9">${mn.toFixed(3)}</text>`;
    }
  });
}, 1000);
</script></body></html>"""


class Viewer:
    """Publishes frames; queues camera events for the render loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._png = b""
        self._stats = {"iteration": 0, "fps": 0.0, "loss": 0.0}
        self._lock = threading.Lock()
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self.actions: "queue.Queue[str]" = queue.Queue()
        # parameter edits (render mode / encoding / hyperparams / tonemapper
        # / material fields) queued for the render loop, like camera verbs
        self.settings: "queue.Queue[dict]" = queue.Queue()
        self.params_provider = lambda: {}
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif url.path == "/frame.png":
                    with viewer._lock:
                        body = viewer._png
                    ctype = "image/png"
                elif url.path == "/stats":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    ctype = "application/json"
                elif url.path == "/control":
                    q = parse_qs(url.query)
                    op = q.get("op", [""])[0]
                    args = tuple(
                        float(q.get(k, ["0"])[0]) for k in ("dx", "dy", "d")
                    )
                    if op in ("orbit", "pan", "dolly", "zoom"):
                        viewer.events.put((op, args))
                    body, ctype = b"ok", "text/plain"
                elif url.path == "/params":
                    # current GUI state (the reference rebuilds its ImGui
                    # widgets from live state each frame; we serve it once
                    # per page load)
                    try:
                        body = json.dumps(viewer.params_provider()).encode()
                    except Exception as e:  # provider races with shutdown
                        body = json.dumps({"error": repr(e)}).encode()
                    ctype = "application/json"
                elif url.path == "/set":
                    q = parse_qs(url.query)
                    viewer.settings.put(
                        {
                            "key": q.get("key", [""])[0],
                            "value": q.get("value", [""])[0],
                            "material": (
                                int(q["material"][0]) if "material" in q else None
                            ),
                        }
                    )
                    body, ctype = b"ok", "text/plain"
                elif url.path == "/action":
                    # key-handler parity (Application.cpp:572-648): P/H
                    # screenshots, S save-system; plus the Stats-window
                    # cache-reset button (Raytracer::resetRadianceCache)
                    op = parse_qs(url.query).get("op", [""])[0]
                    if op in (
                        "screenshot_png", "screenshot_hdr",
                        "save_system", "reset_cache",
                    ):
                        viewer.actions.put(op)
                    body, ctype = b"ok", "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self._server.server_address[0]}:{self.port}/"

    def publish(self, png_bytes: bytes, iteration: int, fps: float,
                loss: float, loss_history=()) -> None:
        with self._lock:
            self._png = png_bytes
            self._stats = {
                "iteration": int(iteration),
                "fps": float(fps),
                "loss": float(loss),
                "loss_history": [float(x) for x in loss_history],
            }

    def drain_events(self) -> list:
        """Queued camera verbs as data, ``[(op, (dx, dy, d)), ...]``: the
        present loop over ranks drains them on rank 0 and applies them on
        every rank (``apply_camera_events``)."""
        out = []
        while True:
            try:
                out.append(self.events.get_nowait())
            except queue.Empty:
                break
        return out

    def drain_actions(self) -> list:
        """Queued one-shot actions (screenshots / save-system / cache reset)."""
        out = []
        while True:
            try:
                out.append(self.actions.get_nowait())
            except queue.Empty:
                break
        return out

    def drain_settings(self) -> list:
        """Queued parameter edits from the control panel."""
        out = []
        while True:
            try:
                out.append(self.settings.get_nowait())
            except queue.Empty:
                break
        return out

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # the provider closes over the renderer, and the server's handler
        # over this viewer: let the renderer go with the loop that ends
        self.params_provider = lambda: {}


def apply_camera_events(camera, events) -> bool:
    """Apply camera verbs (``Viewer.drain_events``) to ``camera`` in order;
    True if any applied (the caller restarts the accumulation,
    ``Application::restartRendering``)."""
    for op, (dx, dy, d) in events:
        if op == "orbit":
            camera.orbit(dx, dy)
        elif op == "pan":
            camera.pan(dx, dy)
        elif op == "dolly":
            camera.dolly(d * camera.distance * 0.1)
        elif op == "zoom":
            camera.zoom(-d * 2.0)
    return bool(events)
