"""PyTorch port, the viewer on the CPU: ``OrbitCameraController``'s orbit,
zoom, pan, recenter and rebuilt camera against the JAX package's numbers
(tests/test_viewer_cli.py's sequence), and ``PreviewServer``: frames, a
camera control that resets the accumulation, the CSRF and host guards, one
WebSocket frame and the denoise toggle.
"""

import base64
import hashlib
import json
import os
import socket
import struct
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene as JScene
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene as jparse
from cosc_4397_pathtracing_raytracing_project_tpu.viewer.controls import (
    OrbitCameraController as JController,
)
from cosc_4397_pathtracing_raytracing_project_tpu_torch import RenderConfig, Renderer, parse_scene
from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer import (
    OrbitCameraController,
    PreviewServer,
)

from test_render import CORNELL_SMALL

torch.set_num_threads(2)

_CAMERA_FIELDS = ("position", "view", "up", "right", "pixel_length", "aperture", "focal")


def _controllers():
    desc = parse_scene(CORNELL_SMALL)
    r = Renderer(desc, RenderConfig(samples_per_launch=2), device="cpu")
    port = OrbitCameraController.from_camera(r.scene.camera, lookat=desc.camera.lookat)
    jdesc = jparse(CORNELL_SMALL)
    oracle = JController.from_camera(JScene.from_desc(jdesc).camera, lookat=jdesc.camera.lookat)
    return r, port, oracle


def _assert_same(port, oracle):
    for f in ("zoom", "phi", "theta", "width", "height", "changed", "aperture", "focal"):
        assert getattr(port, f) == getattr(oracle, f), f
    np.testing.assert_array_equal(port.lookat, oracle.lookat)
    np.testing.assert_array_equal(port.og_lookat, oracle.og_lookat)
    got, want = port.camera(), oracle.camera()
    assert got.resolution == want.resolution
    for f in _CAMERA_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)


def test_orbit_controller_matches_jax():
    """tests/test_viewer_cli.py's interactions, each applied to both
    controllers: the same spherical state and the same rebuilt camera,
    bit for bit (both rebuild it in float64 NumPy)."""
    r, port, oracle = _controllers()
    first = port.camera()
    for f in ("position", "view"):
        np.testing.assert_allclose(getattr(first, f).numpy(),
                                   getattr(r.scene.camera, f).numpy(), atol=1e-4)
    h = port.height
    for action, args in (("orbit", (32, -16)), ("zoom_by", (-h,)), ("zoom_by", (10 * h,)),
                         ("orbit", (0, -10 * h)), ("orbit", (0, 10 * h)), ("pan", (50, -30)),
                         ("recenter", ())):
        getattr(port, action)(*args)
        getattr(oracle, action)(*args)
        _assert_same(port, oracle)
    assert port.theta == pytest.approx(0.001)
    np.testing.assert_allclose(port.lookat, port.og_lookat)


def test_camera_lands_on_the_renderer_device():
    r, port, _ = _controllers()
    r.step(2)
    port.orbit(100, 0)
    cam = port.camera()
    assert cam.position.device == r.device and cam.focal.dtype == torch.float32
    r.set_camera(cam)
    assert r.iteration == 0
    r.step(2)
    assert torch.isfinite(r.state.accum).all()


@pytest.fixture
def server():
    desc = parse_scene(CORNELL_SMALL)
    r = Renderer(desc, RenderConfig(trace_depth=3, samples_per_launch=2), device="cpu")
    srv = PreviewServer(r, lookat=desc.camera.lookat, host="127.0.0.1", port=0)
    srv.start(block=False)
    try:
        yield srv
    finally:
        srv.stop()
    assert not srv._render_thread.is_alive()


def _post(base, msg, headers=None):
    req = urllib.request.Request(base + "/control", data=json.dumps(msg).encode(),
                                 method="POST", headers=headers or {})
    return urllib.request.urlopen(req, timeout=30).read()


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_preview_server_frames_and_controls(server):
    base = f"http://127.0.0.1:{server.port}"
    assert b"Path Tracer" in urllib.request.urlopen(base + "/", timeout=10).read()
    for _ in range(2):
        assert urllib.request.urlopen(base + "/frame.png", timeout=30).read()[:4] == b"\x89PNG"
    stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=10).read())
    assert "Path Tracer Analytics" in stats["text"]
    # an orbit rebuilds the camera and resets the accumulation to iteration 0
    r = server.renderer
    _wait(lambda: r.iteration >= r.target_iterations, "the first frame's samples")
    resets = []
    set_camera = r.set_camera
    r.set_camera = lambda cam: (resets.append(r.iteration), set_camera(cam),
                                resets.append(r.iteration))
    gen = server._camera_gen
    _post(base, {"type": "orbit", "dx": 60, "dy": 0})
    _wait(lambda: server._camera_gen == gen + 1, "the camera rebuild")
    assert resets == [r.target_iterations, 0]
    # a cross-origin POST and a DNS-rebinding POST are refused
    for headers in ({"Origin": "http://evil.example"},
                    {"Origin": f"http://evil.example:{server.port}",
                     "Host": f"evil.example:{server.port}"}):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, {"type": "orbit", "dx": 1, "dy": 0}, headers)
        assert err.value.code == 403


def test_preview_websocket_frame(server):
    """RFC 6455 handshake with the right accept digest, then one binary
    frame: the (w, h, camera_gen, iteration) header and w·h RGBA bytes."""
    key = base64.b64encode(os.urandom(16)).decode()
    s = socket.create_connection(("127.0.0.1", server.port), timeout=60)
    try:
        s.sendall((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{server.port}\r\n"
                   "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, buf = buf.split(b"\r\n\r\n", 1)
        assert b" 101 " in head.split(b"\r\n")[0]
        accept = base64.b64encode(hashlib.sha1(
            (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
        assert accept in head
        while len(buf) < 4:
            buf += s.recv(65536)
        assert buf[0] == 0x82 and buf[1] & 0x7F == 126  # FIN + binary, 16-bit length
        n = struct.unpack("!H", buf[2:4])[0]
        while len(buf) < 4 + n:
            buf += s.recv(65536)
        payload = buf[4:4 + n]
        w, h, _, _ = struct.unpack("<IIII", payload[:16])
        assert (w, h) == (64, 64) and n == 16 + w * h * 4 and payload[19] == 255
        s.sendall(struct.pack("!BB4s", 0x88, 0x80, b"\x00\x00\x00\x00"))  # close
    finally:
        s.close()


def test_preview_denoise_toggle(server):
    base = f"http://127.0.0.1:{server.port}"

    def stats_text():
        return json.loads(urllib.request.urlopen(base + "/stats", timeout=10).read())["text"]

    assert "denoise [d]: off" in stats_text()
    _post(base, {"type": "key", "key": "d"})
    assert "denoise [d]: on" in stats_text()
    assert urllib.request.urlopen(base + "/frame.png", timeout=60).read()[:4] == b"\x89PNG"
    assert server._aovs is not None and server._aovs.albedo.shape == (64, 64, 3)
    _post(base, {"type": "key", "key": "d"})
    assert "denoise [d]: off" in stats_text()
