"""Orbit controls parity, checkpoint round-trip, CLI, and preview server."""

import json
import os
import sys
import threading
import urllib.request

import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
from cosc_4397_pathtracing_raytracing_project_tpu.scene import (
    Scene,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu.viewer.controls import (
    OrbitCameraController,
)

from test_render import CORNELL_SMALL


@pytest.fixture
def small_desc():
    return parse_scene(CORNELL_SMALL)


def test_orbit_controller_roundtrip(small_desc):
    scene = Scene.from_desc(small_desc)
    ctl = OrbitCameraController.from_camera(
        scene.camera, lookat=small_desc.camera.lookat
    )
    # initial reconstruction matches the scene camera (reference first frame)
    cam = ctl.camera()
    np.testing.assert_allclose(
        np.asarray(cam.position), np.asarray(scene.camera.position), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(cam.view), np.asarray(scene.camera.view), atol=1e-4
    )


def test_orbit_math_matches_reference(small_desc):
    scene = Scene.from_desc(small_desc)
    ctl = OrbitCameraController.from_camera(
        scene.camera, lookat=small_desc.camera.lookat
    )
    w, h = ctl.width, ctl.height
    phi0, theta0, zoom0 = ctl.phi, ctl.theta, ctl.zoom
    ctl.orbit(32, -16)  # main.cpp:192-193: phi -= dx/width, theta -= dy/height
    assert ctl.phi == pytest.approx(phi0 - 32 / w)
    assert ctl.theta == pytest.approx(theta0 + 16 / h)
    ctl.zoom_by(-h)  # main.cpp:198-199 with clamp at 0.1
    assert ctl.zoom == pytest.approx(max(0.1, zoom0 - 1.0))
    ctl.zoom_by(10 * h)
    # theta clamp
    ctl.orbit(0, -10 * h)
    assert ctl.theta == pytest.approx(np.pi)
    ctl.orbit(0, 10 * h)
    assert ctl.theta == pytest.approx(0.001)
    # pan then recenter restores the original lookAt
    look0 = ctl.lookat.copy()
    ctl.pan(50, -30)
    assert not np.allclose(ctl.lookat, look0)
    ctl.recenter()
    np.testing.assert_allclose(ctl.lookat, ctl.og_lookat)


def test_camera_change_resets_and_resumes(small_desc):
    r = Renderer(small_desc, RenderConfig(samples_per_launch=2))
    r.step(2)
    ctl = OrbitCameraController.from_camera(
        r.scene.camera, lookat=small_desc.camera.lookat
    )
    ctl.orbit(100, 0)
    r.set_camera(ctl.camera())
    assert r.iteration == 0
    r.step(2)
    assert np.isfinite(np.asarray(r.state.accum)).all()


def test_checkpoint_roundtrip(tmp_path, small_desc):
    a = Renderer(small_desc, RenderConfig(samples_per_launch=4), seed=11)
    a.step(4)
    path = a.save_checkpoint(str(tmp_path / "ckpt"))
    # resume into a fresh renderer and continue
    b = Renderer(small_desc, RenderConfig(samples_per_launch=4), seed=11)
    b.load_checkpoint(path)
    assert b.iteration == 4
    a.step(4)
    b.step(4)
    np.testing.assert_array_equal(np.asarray(a.state.accum), np.asarray(b.state.accum))


def test_cli_headless(tmp_path, monkeypatch):
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cli import main

    scene_path = tmp_path / "scene.txt"
    scene_path.write_text(CORNELL_SMALL)
    out = tmp_path / "out.png"
    ckpt = tmp_path / "ck.npz"
    rc = main(
        [
            str(scene_path),
            "--iterations", "4",
            "--chunk", "2",
            "--output", str(out),
            "--checkpoint", str(ckpt),
            "--quiet",
        ]
    )
    assert rc == 0
    assert out.exists() and ckpt.exists()
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png

    img = read_png(str(out))
    assert img.shape == (64, 64, 3)
    # resume path
    rc = main(
        [
            str(scene_path),
            "--iterations", "6",
            "--chunk", "2",
            "--resume", str(ckpt),
            "--output", str(tmp_path / "out2.png"),
            "--quiet",
        ]
    )
    assert rc == 0


def test_preview_server(small_desc):
    from cosc_4397_pathtracing_raytracing_project_tpu.viewer.server import (
        PreviewServer,
    )

    r = Renderer(small_desc, RenderConfig(samples_per_launch=2))
    srv = PreviewServer(r, lookat=small_desc.camera.lookat, host="127.0.0.1", port=0)
    srv.start(block=False)
    try:
        port = srv._httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"
        html = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"JAX Path Tracer" in html
        frame = urllib.request.urlopen(base + "/frame.png", timeout=30).read()
        assert frame[:4] == b"\x89PNG"
        stats = json.loads(
            urllib.request.urlopen(base + "/stats", timeout=10).read()
        )
        assert "Path Tracer Analytics" in stats["text"]
        # orbit control resets accumulation
        req = urllib.request.Request(
            base + "/control",
            data=json.dumps({"type": "orbit", "dx": 60, "dy": 0}).encode(),
            method="POST",
        )
        urllib.request.urlopen(req, timeout=10).read()
        # CSRF guards: a cross-origin browser POST is rejected, and so is a
        # DNS-rebinding POST (attacker hostname in BOTH Origin and Host —
        # Origin==Host alone would pass it)
        for headers in (
            {"Origin": "http://evil.example"},
            {"Origin": f"http://evil.example:{port}",
             "Host": f"evil.example:{port}"},
        ):
            bad = urllib.request.Request(
                base + "/control",
                data=json.dumps({"type": "orbit", "dx": 1, "dy": 0}).encode(),
                method="POST",
                headers=headers,
            )
            try:
                urllib.request.urlopen(bad, timeout=10)
                raise AssertionError(f"expected 403 for {headers}")
            except urllib.error.HTTPError as e:
                assert e.code == 403
        # multipart push stream delivers at least two PNG parts as the
        # accumulator advances
        resp = urllib.request.urlopen(base + "/stream", timeout=30)
        assert "multipart/x-mixed-replace" in resp.headers.get("Content-Type", "")
        buf = b""
        import time as _time

        deadline = _time.monotonic() + 60
        while buf.count(b"\x89PNG") < 2 and _time.monotonic() < deadline:
            buf += resp.read1(65536)
        assert buf.count(b"--frame") >= 2
        assert buf.count(b"\x89PNG") >= 2
    finally:
        srv.stop()


def test_preview_websocket_stream(small_desc):
    """The /ws transport (raw-RGBA push, no PNG encode): RFC 6455 handshake
    succeeds with the correct Accept digest, frames carry the (w, h,
    camera_gen, iteration) header + w·h·4 RGBA bytes, successive frames
    advance the iteration, and a cross-origin upgrade is refused (WS frame
    bytes are readable cross-origin, unlike <img> transports)."""
    import base64 as b64
    import hashlib
    import os as _os
    import socket
    import struct
    import time as _time

    from cosc_4397_pathtracing_raytracing_project_tpu.viewer.server import (
        PreviewServer,
    )

    r = Renderer(small_desc, RenderConfig(samples_per_launch=2))
    srv = PreviewServer(
        r, lookat=small_desc.camera.lookat, host="127.0.0.1", port=0
    )
    srv.start(block=False)
    try:
        port = srv._httpd.server_address[1]
        key = b64.b64encode(_os.urandom(16)).decode()
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(
            (
                f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(4096)
        head, buf = buf.split(b"\r\n\r\n", 1)
        assert b" 101 " in head.split(b"\r\n")[0]
        want = b64.b64encode(
            hashlib.sha1(
                (key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()
            ).digest()
        )
        assert want in head

        def read_exact(n, buf):
            deadline = _time.monotonic() + 60
            while len(buf) < n and _time.monotonic() < deadline:
                buf += s.recv(65536)
            assert len(buf) >= n, "ws read timed out"
            return buf[:n], buf[n:]

        def read_frame(buf):
            hdr, buf = read_exact(2, buf)
            assert hdr[0] == 0x82  # FIN + binary
            ln = hdr[1] & 0x7F
            if ln == 126:
                ext, buf = read_exact(2, buf)
                ln = struct.unpack("!H", ext)[0]
            elif ln == 127:
                ext, buf = read_exact(8, buf)
                ln = struct.unpack("!Q", ext)[0]
            payload, buf = read_exact(ln, buf)
            return payload, buf
        p1, buf = read_frame(buf)
        w, h, _gen, it1 = struct.unpack("<IIII", p1[:16])
        assert (w, h) == (64, 64)
        assert len(p1) == 16 + w * h * 4
        assert p1[19] == 255  # alpha of pixel 0
        p2, buf = read_frame(buf)
        _, _, _, it2 = struct.unpack("<IIII", p2[:16])
        assert it2 > it1  # the push advanced with the accumulator
        # masked client close frame ends the session server-side
        s.sendall(struct.pack("!BB4s", 0x88, 0x80, b"\x00\x00\x00\x00"))
        s.close()

        # cross-origin (DNS-rebinding shape) upgrade is refused
        s2 = socket.create_connection(("127.0.0.1", port), timeout=30)
        s2.sendall(
            (
                f"GET /ws HTTP/1.1\r\nHost: evil.example:{port}\r\n"
                f"Origin: http://evil.example:{port}\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        resp = b""
        deadline = _time.monotonic() + 30
        while b"\r\n" not in resp and _time.monotonic() < deadline:
            resp += s2.recv(4096)
        assert b" 403 " in resp.split(b"\r\n")[0]
        s2.close()
    finally:
        srv.stop()


def test_preview_denoise_toggle(small_desc):
    """'d' toggles the display denoiser: stats reflect it, frames still
    serve (fresh bytes under the new frame key), and 'd' again restores."""
    from cosc_4397_pathtracing_raytracing_project_tpu.viewer.server import (
        PreviewServer,
    )

    r = Renderer(small_desc, RenderConfig(samples_per_launch=2))
    srv = PreviewServer(
        r, lookat=small_desc.camera.lookat, host="127.0.0.1", port=0
    )
    srv.start(block=False)
    try:
        port = srv._httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"

        def press_d():
            req = urllib.request.Request(
                base + "/control",
                data=json.dumps({"type": "key", "key": "d"}).encode(),
                method="POST",
            )
            urllib.request.urlopen(req, timeout=10).read()

        def stats_text():
            return json.loads(
                urllib.request.urlopen(base + "/stats", timeout=10).read()
            )["text"]

        assert "denoise [d]: off" in stats_text()
        press_d()
        assert "denoise [d]: on" in stats_text()
        frame = urllib.request.urlopen(base + "/frame.png", timeout=60).read()
        assert frame[:4] == b"\x89PNG"
        press_d()
        assert "denoise [d]: off" in stats_text()
    finally:
        srv.stop()
