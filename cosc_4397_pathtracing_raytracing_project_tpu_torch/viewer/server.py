"""Interactive preview: a zero-dependency web viewer.

Port of the JAX package's ``viewer/server.py``. The display path is
host-side, as there: the renderer accumulates on its device continuously in
a background thread and frames push to the browser (the `sendImageToPBO`
gamma path, `pathtrace.cu:250-268`) entirely off the timed render path. The
render thread names the renderer's CUDA device explicitly, and reads of the
renderer's state that key a frame are taken under the server's lock, as in
the JAX package.

Display transports, fastest first:

1. `/ws` — a WebSocket (RFC 6455 handshake done by hand; still zero
   dependencies) pushing RAW RGBA frames drawn via canvas ``putImageData``.
   This skips the per-frame PNG encode completely: zlib on the host, not
   the network, limits the display rate of the PNG transports.
2. `/stream` — multipart/x-mixed-replace PNG push (browsers without WS).
3. `/frame.png` polling — the last-resort fallback.

Controls mirror the reference window (`src/main.cpp:158-218`): left-drag
orbit, right-drag zoom, middle-drag (or shift-drag) pan, Space recenter,
S save PNG, Esc save + stop. An overlay shows the metrics block the
reference printed per iteration ("Path Tracer Analytics", `preview.cpp:192`).
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..io.png import encode_png
from ..render.engine import Renderer
from .controls import OrbitCameraController

_PAGE = """<!doctype html>
<html><head><title>Path Tracer (PyTorch/CUDA)</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#wrap { display:flex } #view { cursor:grab }
#hud { padding:12px; white-space:pre; font-size:12px }
</style></head><body>
<div id="wrap"><div id="view"><canvas id="cv" style="display:none"></canvas>
<img id="c" draggable="false" style="display:none"></div>
<div id="hud">loading…</div></div>
<script>
const view = document.getElementById('view'), hud = document.getElementById('hud');
const cv = document.getElementById('cv'), c = document.getElementById('c');
let drag = null;
view.oncontextmenu = e => e.preventDefault();
view.onmousedown = e => { e.preventDefault();
  drag = {x: e.clientX, y: e.clientY, b: e.button, shift: e.shiftKey}; };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  const kind = (drag.b === 1 || drag.shift) ? 'pan' : drag.b === 2 ? 'zoom' : 'orbit';
  fetch('/control', {method:'POST', body: JSON.stringify({type: kind, dx, dy})});
};
window.onkeydown = e => {
  if (['s','S',' ','Escape','d','D'].includes(e.key))
    fetch('/control', {method:'POST', body: JSON.stringify({type:'key', key:e.key})});
};
// Display transport 1: WebSocket pushing RAW RGBA (no PNG encode on the
// server — the encode, not the network, was the display bottleneck).
// Frame = 16-byte LE header (w, h, camera_gen, iteration) + RGBA bytes.
function multipart() {
  // Transport 2: multipart/x-mixed-replace PNG push; on error fall back
  // to transport 3, /frame.png polling (load off-screen and only swap on
  // success: reassigning c.src every tick would abort in-flight loads on
  // slow links and never display).
  cv.style.display = 'none'; c.style.display = '';
  let polling = false;
  function poll() {
    if (polling) return; polling = true;
    (function tick() {
      const im = new Image();
      im.onload = () => { c.src = im.src; setTimeout(tick, 60); };
      im.onerror = () => setTimeout(tick, 500);
      im.src = '/frame.png?t=' + Date.now();
    })();
  }
  c.onerror = poll;
  c.src = '/stream';
  setTimeout(() => { if (!c.naturalWidth) poll(); }, 3000);
}
(function ws() {
  let opened = false;
  let sock;
  try { sock = new WebSocket('ws://' + location.host + '/ws'); }
  catch (e) { multipart(); return; }
  sock.binaryType = 'arraybuffer';
  sock.onopen = () => { opened = true; };
  sock.onmessage = ev => {
    const dv = new DataView(ev.data);
    const w = dv.getUint32(0, true), h = dv.getUint32(4, true);
    if (cv.width !== w || cv.height !== h) { cv.width = w; cv.height = h; }
    cv.style.display = ''; c.style.display = 'none';
    const img = new ImageData(new Uint8ClampedArray(ev.data, 16), w, h);
    cv.getContext('2d').putImageData(img, 0, 0);
  };
  sock.onerror = () => { if (!opened) multipart(); };
  sock.onclose = () => { if (!opened) multipart(); };
})();
(async function stats() {
  try {
    const s = await (await fetch('/stats')).json();
    hud.textContent = s.text;
  } catch (e) {}
  setTimeout(stats, 250);
})();
</script></body></html>"""


class PreviewServer:
    """Drives a Renderer in a background thread and serves frames + controls."""

    def __init__(self, renderer: Renderer, lookat=None, host="127.0.0.1", port=8634):
        # host defaults to loopback: /control mutates renderer state and
        # writes PNGs to the CWD with no auth — binding 0.0.0.0 is opt-in.
        self.renderer = renderer
        self.controls = OrbitCameraController.from_camera(
            renderer.scene.camera,
            lookat=lookat
            if lookat is not None
            else (renderer.desc.camera.lookat if renderer.desc else None),
            # an explicit scene-file FOCAL stays fixed through orbits;
            # auto (FOCAL ≤ 0 / absent) refocuses on lookat every rebuild
            focal_auto=(renderer.desc.camera.focal <= 0)
            if renderer.desc
            else True,
        )
        self.host = host
        self.port = port
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._render_thread = None
        self._httpd = None
        self._frame_cache = ((-1, -1), b"")  # (frame key, png)
        self._camera_gen = 0  # bumped on every camera rebuild
        # 'd' toggles the À-Trous denoiser on the displayed frames (the
        # accumulator itself stays untouched); the AOV pass is cached per
        # camera generation — it only depends on the pose.
        self._denoise = False
        self._aovs = None
        self._aovs_gen = -1
        self._frame_times: list = []  # recent distinct-frame timestamps
        self._raw_cache = ((-1, -1), b"")  # (frame key, ws payload)

    # ── render loop (the mainLoop/runCuda analog) ──

    def _render_loop(self):
        dev = self.renderer.device
        # a new thread's current CUDA device is the default one: name the
        # renderer's
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            while not self._stop.is_set():
                with self._lock:
                    if self.controls.changed:
                        # camera change → rebuild basis, reset accumulation
                        self.renderer.set_camera(self.controls.camera())
                        self._camera_gen += 1
                    target = self.renderer.target_iterations or 0
                if target and self.renderer.iteration >= target:
                    self._stop.wait(0.1)
                    continue
                self.renderer.step(self.renderer.config.samples_per_launch)

    def frame_png_keyed(self) -> tuple:
        """((camera gen, iteration), png) from ONE snapshot — the stream
        loop needs the key that belongs to the bytes it writes (reading the
        cache after the fact races with concurrent /frame.png encodes).

        Re-encodes only when the accumulator advanced; keyed by (camera
        generation, iteration) because iteration alone collides after a
        camera reset (a coinciding value would serve the pre-move frame)."""
        # Snapshot the key under the lock: the render thread bumps
        # _camera_gen and resets the iteration counter together under it, so
        # an unlocked pair read could cache a post-move frame under a
        # pre-move key for one tick.
        with self._lock:
            key = (self._camera_gen, self.renderer.iteration, self._denoise)
            cached_key, cached = self._frame_cache
        if key == cached_key and cached:
            return key, cached
        if key[2]:
            img = self._denoised_display(key[0])[:, ::-1, :]
        else:
            img = self.renderer.display_image()[:, ::-1, :]
        png = encode_png(img, compress_level=1)
        import time as _time

        with self._lock:
            self._frame_cache = (key, png)
            self._frame_times.append(_time.monotonic())
            if len(self._frame_times) > 20:
                self._frame_times = self._frame_times[-20:]
        return key, png

    def frame_png(self) -> bytes:
        return self.frame_png_keyed()[1]

    def frame_raw_keyed(self) -> tuple:
        """((camera gen, iteration, denoise), payload) for the WebSocket
        transport: 16-byte LE header (w, h, camera_gen, iteration) + the
        tonemapped display image as raw RGBA rows. No codec work at all:
        the per-frame PNG encode, not the loopback network, limits the
        multipart stream's display fps."""
        import numpy as np

        with self._lock:
            key = (self._camera_gen, self.renderer.iteration, self._denoise)
            cached_key, cached = self._raw_cache
        if key == cached_key and cached:
            return key, cached
        if key[2]:
            img = self._denoised_display(key[0])[:, ::-1, :]
        else:
            img = self.renderer.display_image()[:, ::-1, :]
        h, w = img.shape[:2]
        rgba = np.empty((h, w, 4), np.uint8)
        rgba[..., :3] = img
        rgba[..., 3] = 255
        payload = (
            struct.pack(
                "<IIII", w, h, key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF
            )
            + rgba.tobytes()
        )
        import time as _time

        with self._lock:
            self._raw_cache = (key, payload)
            self._frame_times.append(_time.monotonic())
            if len(self._frame_times) > 20:
                self._frame_times = self._frame_times[-20:]
        return key, payload

    def _denoised_display(self, camera_gen: int):
        """uint8 gamma view of the denoised accumulator mean, filtered on
        the renderer's device. AOVs rebuild only when the camera moved
        (they are pose-only)."""
        import numpy as np

        from ..render.denoise import atrous_denoise, render_aovs

        if self._aovs is None or self._aovs_gen != camera_gen:
            aovs = render_aovs(self.renderer.scene)
            self._aovs, self._aovs_gen = aovs, camera_gen
        img = torch.as_tensor(self.renderer.linear_image(), device=self.renderer.device)
        lin = atrous_denoise(img, self._aovs).cpu().numpy()
        return (np.clip(lin, 0.0, 1.0) ** (1.0 / 2.2) * 255.0).astype(
            np.uint8
        )

    def display_fps(self) -> float:
        """Distinct preview frames served per second (the ImGui framerate
        analog, `src/preview.cpp:221`)."""
        with self._lock:
            ts = list(self._frame_times)
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return 0.0
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def stats_text(self) -> str:
        m = self.renderer.metrics
        return (
            f"Path Tracer Analytics\n"
            f"iteration: {self.renderer.iteration}\n"
            f"display fps: {self.display_fps():.1f}\n"
            f"denoise [d]: {'on' if self._denoise else 'off'}\n"
            + m.summary()
        )

    def handle_control(self, msg: dict) -> None:
        with self._lock:
            kind = msg.get("type")
            if kind == "orbit":
                self.controls.orbit(msg.get("dx", 0), msg.get("dy", 0))
            elif kind == "zoom":
                self.controls.zoom_by(msg.get("dy", 0))
            elif kind == "pan":
                self.controls.pan(msg.get("dx", 0), msg.get("dy", 0))
            elif kind == "key":
                key = msg.get("key")
                if key in ("d", "D"):
                    self._denoise = not self._denoise
                elif key in ("s", "S"):
                    self.renderer.save_png(denoise=self._denoise)
                elif key == " ":
                    self.controls.recenter()
                elif key == "Escape":
                    self.renderer.save_png()
                    self._stop.set()

    # ── HTTP plumbing ──

    def _make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    self._send(200, "image/png", server.frame_png())
                elif self.path.startswith("/stream"):
                    # server-push preview: one long-lived multipart
                    # response; a new part is written the moment the
                    # accumulator advances (ThreadingHTTPServer gives this
                    # connection its own thread, so control/stats requests
                    # keep flowing). The reference redraws from the CUDA-GL
                    # PBO every frame (`src/preview.cpp:235-259`); this is
                    # the push-display analog for a browser client.
                    import time as _time

                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    last = None
                    try:
                        while not server._stop.is_set():
                            key, png = server.frame_png_keyed()
                            if key != last:
                                last = key
                                self.wfile.write(
                                    b"--frame\r\n"
                                    b"Content-Type: image/png\r\n"
                                    + f"Content-Length: {len(png)}\r\n\r\n".encode()
                                    + png
                                    + b"\r\n"
                                )
                                self.wfile.flush()
                            else:
                                _time.sleep(0.03)
                    except (BrokenPipeError, ConnectionError, OSError):
                        pass  # client navigated away
                elif self.path.startswith("/ws"):
                    self._serve_websocket()
                elif self.path.startswith("/stats"):
                    body = json.dumps({"text": server.stats_text()}).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(200, "text/html", _PAGE.encode())

            # ── WebSocket push (RFC 6455, by hand — zero dependencies) ──

            def _serve_websocket(self):
                # Unlike <img>-tag transports, a cross-origin page CAN read
                # WS frame bytes, so gate the upgrade like /control: the
                # Host header must be trustworthy and any Origin must match
                # it (the viewer page connects same-origin).
                wkey = self.headers.get("Sec-WebSocket-Key")
                upgrade = (self.headers.get("Upgrade") or "").lower()
                if upgrade != "websocket" or not wkey:
                    self._send(400, "text/plain", b"websocket endpoint")
                    return
                if not self._host_allowed():
                    self._send(403, "application/json", b'{"error":"host"}')
                    return
                origin = self.headers.get("Origin")
                if origin is not None:
                    from urllib.parse import urlparse

                    host_hdr = (self.headers.get("Host") or "").strip()
                    if urlparse(origin).netloc != host_hdr:
                        self._send(403, "application/json",
                                   b'{"error":"origin"}')
                        return
                accept = base64.b64encode(
                    hashlib.sha1(
                        (wkey + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11")
                        .encode()
                    ).digest()
                ).decode()
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept)
                self.end_headers()

                import socket as _socket
                import time as _time

                def ws_send(payload: bytes):
                    n = len(payload)
                    if n < 126:
                        hdr = struct.pack("!BB", 0x82, n)
                    elif n < (1 << 16):
                        hdr = struct.pack("!BBH", 0x82, 126, n)
                    else:
                        hdr = struct.pack("!BBQ", 0x82, 127, n)
                    self.wfile.write(hdr + payload)
                    self.wfile.flush()

                last = None
                try:
                    while not server._stop.is_set():
                        # drain client frames without blocking the push
                        # loop; a close frame (opcode 8) ends the session.
                        # (Browsers don't ping; anything else is ignored.)
                        self.connection.settimeout(0.001)
                        try:
                            buf = self.connection.recv(1024)
                            if not buf or (buf[0] & 0x0F) == 0x8:
                                break
                        except (_socket.timeout, BlockingIOError):
                            pass
                        finally:
                            self.connection.settimeout(30.0)
                        key, payload = server.frame_raw_keyed()
                        if key != last:
                            last = key
                            ws_send(payload)
                        else:
                            _time.sleep(0.03)
                except (BrokenPipeError, ConnectionError, OSError):
                    pass  # client navigated away

            def _host_allowed(self):
                # DNS-rebinding defense: Origin==Host alone passes when an
                # attacker's domain resolves to this server (both headers
                # then carry the attacker's name). Require the Host header
                # itself to be trustworthy: an IP literal (no DNS involved,
                # can't be rebound), localhost, or the configured bind host;
                # and the port must match the bind port.
                from urllib.parse import urlsplit

                host_hdr = (self.headers.get("Host") or "").strip()
                try:
                    sp = urlsplit("//" + host_hdr)
                    hostname, port = (sp.hostname or "").lower(), sp.port
                except ValueError:
                    return False
                if (port or 80) != server.port:
                    return False
                if hostname in ("localhost", server.host.lower()):
                    return True
                import ipaddress

                try:
                    ipaddress.ip_address(hostname)
                    return True
                except ValueError:
                    return False

            def do_POST(self):
                # CSRF guard: /control is state-mutating, so reject
                # cross-origin browser posts (any webpage can POST to
                # localhost; the viewer page itself sends same-origin).
                # Same-origin = the Origin's host:port equals the Host
                # header the request arrived on — a fixed hostname
                # allowlist broke 0.0.0.0 binds reached via a LAN IP —
                # plus Host validation (see _host_allowed).
                if not self._host_allowed():
                    self._send(403, "application/json", b'{"error":"host"}')
                    return
                origin = self.headers.get("Origin")
                if origin is not None:
                    from urllib.parse import urlparse

                    host_hdr = (self.headers.get("Host") or "").strip()
                    if urlparse(origin).netloc != host_hdr:
                        self._send(403, "application/json", b'{"error":"origin"}')
                        return
                length = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(length) or b"{}")
                server.handle_control(msg)
                self._send(200, "application/json", b"{}")

        return Handler

    def start(self, block: bool = True):
        self._render_thread = threading.Thread(target=self._render_loop, daemon=True)
        self._render_thread.start()
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), self._make_handler()
        )
        # port=0 binds an ephemeral port — record the real one (Host-header
        # validation and the printed URL both need it)
        self.port = self._httpd.server_address[1]
        print(f"preview at http://{self.host}:{self.port}/")
        if block:
            try:
                while not self._stop.is_set():
                    self._httpd.handle_request()
            except KeyboardInterrupt:
                pass
            self.stop()
        else:
            threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            ).start()
        return self

    def stop(self):
        self._stop.set()
        if self._httpd:
            self._httpd.server_close()
        if self._render_thread:
            self._render_thread.join(timeout=5)
