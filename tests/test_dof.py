"""Thin-lens depth of field (extension — the reference camera is strictly
pinhole, `src/pathtrace.cu:270-286`).

Covers the lens math invariants, the scene-file extension lines, the
static-gate auto-resolution, and cross-pipeline agreement (the reference
and fast pipelines share `rng.lens_uniforms`, so their DOF renders must be
bit-identical, exactly like their pinhole renders)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu.scene import (
    Scene,
    load_scene_desc,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene.structs import Camera
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
    RenderConfig,
    Renderer,
    trace_sample,
)
from cosc_4397_pathtracing_raytracing_project_tpu.ops import (
    camera as cam_ops,
    fast,
    rng as rng_ops,
)


@pytest.fixture()
def lens_camera():
    return Camera(
        position=jnp.array([0.0, 0.0, 10.0]),
        view=jnp.array([0.0, 0.0, -1.0]),
        up=jnp.array([0.0, 1.0, 0.0]),
        right=jnp.array([1.0, 0.0, 0.0]),
        pixel_length=jnp.array([0.01, 0.01]),
        resolution=(8, 8),
        aperture=jnp.float32(0.5),
        focal=jnp.float32(7.0),
    )


def test_lens_rays_pierce_focal_plane(lens_camera):
    """Every lens-sampled ray passes through its pinhole ray's focal-plane
    point — the defining thin-lens property (points on the plane are sharp)."""
    cam = lens_camera
    o0, d0 = cam_ops.generate_rays(cam)
    lens = jnp.stack(
        [jnp.full((64,), 0.8), jnp.linspace(0.0, 1.0, 64)], axis=-1
    )
    o1, d1 = cam_ops.generate_rays(cam, lens=lens)
    ct = o0[:, 2] * 0 + (d0 @ cam.view)
    focus = o0 + d0 * (cam.focal / ct)[:, None]
    t = ((focus - o1) * d1).sum(-1)
    err = jnp.abs(o1 + d1 * t[:, None] - focus).max()
    assert float(err) < 1e-4
    # origins actually moved off the pinhole (aperture > 0, u1 > 0)
    assert float(jnp.abs(o1 - o0).max()) > 0.01


def test_aperture_zero_degenerates_to_pinhole(lens_camera):
    cam = lens_camera.replace(aperture=jnp.float32(0.0))
    o0, d0 = cam_ops.generate_rays(cam)
    lens = jnp.stack(
        [jnp.full((64,), 0.3), jnp.linspace(0.0, 1.0, 64)], axis=-1
    )
    o1, d1 = cam_ops.generate_rays(cam, lens=lens)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o0))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), atol=1e-6)


def _dof_scene_desc(aperture=0.4, focal=-1.0, res=(32, 32)):
    import os
    import tempfile

    src = open("scenes/cornell.txt").read()
    assert "LOOKAT" in src
    src = src.replace(
        "LOOKAT", f"APERTURE    {aperture}\nFOCAL       {focal}\nLOOKAT", 1
    )
    fd, path = tempfile.mkstemp(suffix=".txt")
    with os.fdopen(fd, "w") as f:
        f.write(src)
    desc = load_scene_desc(path)
    os.unlink(path)
    desc.camera.resolution = res
    return desc


def test_parser_aperture_focal_lines():
    desc = _dof_scene_desc(aperture=0.4, focal=2.5)
    assert desc.camera.aperture == 0.4
    assert desc.camera.focal == 2.5
    sc = Scene.from_desc(desc)
    assert float(sc.camera.aperture) == np.float32(0.4)
    assert float(sc.camera.focal) == np.float32(2.5)


def test_focal_auto_is_lookat_distance():
    desc = _dof_scene_desc(aperture=0.4, focal=-1.0)
    sc = Scene.from_desc(desc)
    want = np.linalg.norm(
        np.asarray(desc.camera.eye) - np.asarray(desc.camera.lookat)
    )
    np.testing.assert_allclose(float(sc.camera.focal), want, rtol=1e-5)


def test_renderer_resolves_dof_auto():
    desc = _dof_scene_desc(aperture=0.5)
    assert Renderer(desc).config.dof is True
    pin = load_scene_desc("scenes/cornell.txt")
    pin.camera.resolution = (32, 32)
    assert Renderer(pin).config.dof is False


def test_reference_and_fast_dof_bit_identical():
    desc = _dof_scene_desc(aperture=1.2, res=(32, 32))
    sc = Scene.from_desc(desc)
    cfg = RenderConfig(trace_depth=3, dof=True)
    key = rng_ops.render_key(0)
    a = np.zeros((32 * 32, 3), np.float32)
    b = np.zeros_like(a)
    for it in range(1, 5):
        a += np.asarray(trace_sample(sc, cfg, key, jnp.int32(it)))
        b += np.asarray(fast.trace_sample_fast(sc, cfg, key, jnp.int32(it)))
    np.testing.assert_allclose(a, b, atol=1e-5)
    # and the blur is real: a pinhole render of the same scene differs
    cfg0 = RenderConfig(trace_depth=3, dof=False)
    c = np.asarray(trace_sample(sc, cfg0, key, jnp.int32(1)))
    assert np.abs(np.asarray(trace_sample(sc, cfg, key, jnp.int32(1))) - c).mean() > 1e-4
