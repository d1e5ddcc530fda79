"""Auxiliary subsystems: sphere scene, profiling, debug validation, HDR."""

import os

import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def test_sphere_scene_renders():
    """BASELINE config 2: scenes/sphere.txt (single emissive sphere)."""
    desc = load_scene_desc(os.path.join(SCENES, "sphere.txt"))
    assert desc.iterations == 5000 and desc.num_geoms == 1
    desc.camera.resolution = (64, 64)
    r = Renderer(desc, RenderConfig(samples_per_launch=4))
    r.render(8)
    img = r.linear_image()
    assert np.isfinite(img).all()
    # direct hits on the emittance-5 sphere read 5.0 in linear radiance
    assert img.max() > 4.0
    # the sphere (r=1.5 at origin) is below the camera axis (y=5): bright
    # pixels exist in the lower half
    assert img[32:].max() > img[:16].max()


def test_profile_stages():
    from cosc_4397_pathtracing_raytracing_project_tpu.render.profiling import (
        profile_stages,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene, parse_scene
    from test_render import CORNELL_SMALL

    scene = Scene.from_desc(parse_scene(CORNELL_SMALL))
    stats = profile_stages(scene, RenderConfig(trace_depth=4), reps=2)
    for k in ("raygen_ms", "rng_ms", "intersect_ms", "shade_ms", "gather_ms"):
        assert stats[k] >= 0


def test_profile_pipeline():
    """Bounce-granularity profiling of the resolved production pipeline."""
    from cosc_4397_pathtracing_raytracing_project_tpu.render.profiling import (
        profile_pipeline,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene, parse_scene
    from test_render import CORNELL_SMALL

    scene = Scene.from_desc(parse_scene(CORNELL_SMALL))
    stats = profile_pipeline(scene, RenderConfig(trace_depth=4), reps=1)
    assert stats["pipeline"] == "fast"
    for k in ("total_ms", "bounce1_ms", "per_bounce_ms", "fixed_ms"):
        assert stats[k] >= 0


def test_validate_radiance():
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.debug import (
        validate_radiance,
    )
    import jax.numpy as jnp

    good = jnp.ones((16, 3))
    rep = validate_radiance(good, 4)
    assert rep["healthy"] and rep["mean_radiance"] == pytest.approx(0.25)
    bad = good.at[0, 0].set(jnp.nan).at[1, 1].set(jnp.inf)
    rep = validate_radiance(bad, 4)
    assert not rep["healthy"]
    assert rep["nan_count"] == 1 and rep["inf_count"] == 1


def test_hdr_write(tmp_path):
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import write_hdr

    img = np.random.default_rng(0).uniform(0, 3, (16, 24, 3)).astype(np.float32)
    path = write_hdr(str(tmp_path / "x"), img)
    data = open(path, "rb").read()
    assert data.startswith(b"#?RADIANCE")
    assert b"-Y 16 +X 24" in data
