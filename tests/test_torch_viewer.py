"""PyTorch port, the viewer on the CPU: ``OrbitCameraController``'s orbit,
zoom, pan, recenter and rebuilt camera against the JAX package's numbers
(tests/test_viewer_cli.py's sequence), and ``PreviewServer``: frames, a
camera control that resets the accumulation, the CSRF and host guards, one
WebSocket frame and the denoise toggle; two deliberate deviations from the
JAX server, which keeps both faults: a frame that both encoders make is
timed once for the fps, and the WebSocket drain parses the client's frames,
so only a whole close frame ends a session.
"""

import base64
import hashlib
import json
import os
import socket
import struct
import threading
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
from cosc_4397_pathtracing_raytracing_project_tpu_torch.viewer.server import ClientFrames

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


def test_stopped_server_leaves_no_thread_spinning():
    """stop() ends the HTTP thread: one left polling the closed socket
    spins a core and takes the interpreter lock from every later call."""
    desc = parse_scene(CORNELL_SMALL)
    r = Renderer(desc, RenderConfig(trace_depth=3, samples_per_launch=2), device="cpu")
    srv = PreviewServer(r, lookat=desc.camera.lookat, host="127.0.0.1", port=0)
    before = set(threading.enumerate())
    srv.start(block=False)
    serving = [t for t in set(threading.enumerate()) - before if "serve_forever" in t.name]
    assert len(serving) == 1
    srv.stop()
    assert not serving[0].is_alive() and not srv._render_thread.is_alive()
    cpu = time.process_time()
    time.sleep(0.5)
    assert time.process_time() - cpu < 0.25, "a thread of the stopped server is still running"


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


def _ws_connect(server):
    """A socket past the RFC 6455 handshake (the accept digest checked) and
    the bytes read after it."""
    key = base64.b64encode(os.urandom(16)).decode()
    s = socket.create_connection(("127.0.0.1", server.port), timeout=60)
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
    return s, buf


def _ws_frame(s, buf):
    """The next server frame: (payload, the bytes read after it)."""
    def more():
        data = s.recv(65536)
        assert data, "the server closed the session"
        return data

    while len(buf) < 4:
        buf += more()
    assert buf[0] == 0x82 and buf[1] & 0x7F == 126  # FIN + binary, 16-bit length
    n = struct.unpack("!H", buf[2:4])[0]
    while len(buf) < 4 + n:
        buf += more()
    return buf[4:4 + n], buf[4 + n:]


def _masked(opcode, payload, mask=b"\x00\x00\x00\x00"):
    """A client frame: FIN, ``opcode``, the mask bit and key, the shortest
    length field, the masked payload."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x80 | opcode, 0x80 | n)
    elif n < 1 << 16:
        head = struct.pack("!BBH", 0x80 | opcode, 0x80 | 126, n)
    else:
        head = struct.pack("!BBQ", 0x80 | opcode, 0x80 | 127, n)
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


def test_preview_websocket_frame(server):
    """RFC 6455 handshake with the right accept digest, then one binary
    frame: the (w, h, camera_gen, iteration) header and w·h RGBA bytes."""
    s, buf = _ws_connect(server)
    try:
        payload, _ = _ws_frame(s, buf)
        w, h, _, _ = struct.unpack("<IIII", payload[:16])
        assert (w, h) == (64, 64) and len(payload) == 16 + w * h * 4 and payload[19] == 255
        s.sendall(_masked(0x8, b""))  # close
    finally:
        s.close()


def test_a_frame_made_by_both_encoders_is_timed_once():
    """The PNG and the raw encoder at one (camera gen, iteration, denoise)
    key: one timestamp, whichever encodes first; a new key adds one."""
    desc = parse_scene(CORNELL_SMALL)
    r = Renderer(desc, RenderConfig(trace_depth=2, samples_per_launch=1), device="cpu")
    srv = PreviewServer(r, lookat=desc.camera.lookat, host="127.0.0.1", port=0)
    r.step(1)
    key_png, _ = srv.frame_png_keyed()
    key_raw, _ = srv.frame_raw_keyed()
    assert key_png == key_raw and len(srv._frame_times) == 1
    srv.frame_png_keyed()
    assert len(srv._frame_times) == 1
    r.step(1)
    key_raw, _ = srv.frame_raw_keyed()
    key_png, _ = srv.frame_png_keyed()
    assert key_png == key_raw and [k for k, _ in srv._frame_times] == [
        (0, 1, False), (0, 2, False)]
    assert srv.display_fps() > 0.0


@pytest.mark.parametrize("length", [0, 125, 126, 65535, 65536, 200_000])
def test_client_frames_parse_every_length_field(length):
    """Masked frames of 7-, 16- and 64-bit lengths, fed in pieces of 1 to
    5,000 bytes, each frame whole once its last payload byte is in; a
    payload of 0x88 bytes is payload, not a close."""
    stream = (_masked(0x2, b"\x88" * length, b"\x01\x02\x03\x04")
              + _masked(0x9, b"\x88") + _masked(0x8, b"\x03\xe8"))
    rng = np.random.default_rng(length)
    frames, got, pos = ClientFrames(), [], 0
    while pos < len(stream):
        step = int(rng.integers(1, 5000))
        got += frames.feed(stream[pos:pos + step])
        pos += step
    assert got == [(True, 0x2), (True, 0x9), (True, 0x8)]
    assert ClientFrames().feed(stream[:-1]) == [(True, 0x2), (True, 0x9)]


def test_websocket_payload_bytes_do_not_end_the_session(server):
    """A masked binary frame longer than several of the drain's reads, its
    payload (mask 0) all 0x88, the close frame's first byte: the session
    stays open and pushes the frame of a camera move; a close frame then
    ends it (the server closes the connection)."""
    s, buf = _ws_connect(server)
    try:
        payload, buf = _ws_frame(s, buf)
        gen = struct.unpack("<IIII", payload[:16])[2]
        s.sendall(_masked(0x2, b"\x88" * 20_000))
        time.sleep(0.3)  # the drain reads it while the push loop idles
        _post(f"http://127.0.0.1:{server.port}", {"type": "orbit", "dx": 40, "dy": 0})
        while struct.unpack("<IIII", payload[:16])[2] == gen:
            payload, buf = _ws_frame(s, buf)
        s.sendall(_masked(0x8, b"\x03\xe8"))
        deadline = time.monotonic() + 30.0
        while s.recv(65536):  # frames pushed before the close is read
            assert time.monotonic() < deadline, "the close frame did not end the session"
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
