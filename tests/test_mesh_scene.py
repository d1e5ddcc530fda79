"""Triangle-mesh scene: OBJ loading through the scene format, BVH-accelerated
rendering, and multi-chip sharding over the mesh scene."""

import os

import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
from cosc_4397_pathtracing_raytracing_project_tpu.scene import load_scene_desc, Scene

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture(scope="module")
def mesh_desc():
    path = os.path.join(SCENES, "mesh1080p.txt")
    if not os.path.exists(os.path.join(SCENES, "mesh_sphere.obj")):
        import subprocess, sys

        subprocess.run(
            [sys.executable, os.path.join(SCENES, "..", "scripts", "make_mesh_scene.py"),
             "--out", SCENES],
            check=True,
        )
    desc = load_scene_desc(path)
    # shrink for CPU testing
    desc.camera.resolution = (64, 64)
    return desc


def test_mesh_scene_loads(mesh_desc):
    assert mesh_desc.num_triangles > 30000
    assert mesh_desc.num_geoms == 1  # the emissive panel
    scene = Scene.from_desc(mesh_desc)
    assert scene.triangles.count == mesh_desc.num_triangles


def test_mesh_scene_renders_with_bvh(mesh_desc):
    r = Renderer(
        mesh_desc,
        RenderConfig(
            samples_per_launch=2, trace_depth=4, intersector="bvh",
            pipeline="reference", sky_strength=1.0,
        ),
    )
    r.render(2)
    img = r.linear_image()
    assert np.isfinite(img).all()
    assert img.max() > 0.01  # sky + light reach the sensor
    # the terrain occupies the lower half: it must be hit (non-sky shading)
    assert img[40:].mean() > 0


def test_mesh_scene_auto_uses_bvh(mesh_desc):
    cfg = RenderConfig()
    scene = Scene.from_desc(mesh_desc)
    assert cfg.resolve_intersector(scene) == "bvh"
    # triangle scenes take the readable pipeline and its BVH intersector
    # on every backend; 'fast_mesh' is reachable by name
    assert cfg.resolve_pipeline(scene) == "reference"


def test_mesh_scene_sharded(mesh_desc):
    from cosc_4397_pathtracing_raytracing_project_tpu.parallel import (
        make_mesh,
        render_chunk_sharded,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState
    from cosc_4397_pathtracing_raytracing_project_tpu.ops.bvh import (
        make_bvh_intersector,
    )

    scene = Scene.from_desc(mesh_desc)
    mesh = make_mesh(8, sample_parallel=2)
    state = RenderState.create(scene.camera.pixel_count, seed=0)
    isect = make_bvh_intersector(scene, leaf_size=4)
    cfg = RenderConfig(trace_depth=3, sky_strength=1.0)
    out = render_chunk_sharded(scene, state, cfg, 2, mesh, intersector=isect)
    accum = np.asarray(out.accum)
    assert np.isfinite(accum).all() and accum.max() > 0
