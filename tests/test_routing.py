"""Pipeline routing by scene class, and the removed accelerator-specific
options each rejected with a clear error."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig
from cosc_4397_pathtracing_raytracing_project_tpu.scene import (
    Scene,
    load_scene_desc,
    parse_scene,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene.structs import (
    TriangleBatch,
)

from test_render import CORNELL_SMALL

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _with_triangle(scene):
    tri = TriangleBatch(
        v0=jnp.zeros((1, 3), jnp.float32),
        e1=jnp.asarray([[1.0, 0, 0]]),
        e2=jnp.asarray([[0, 1.0, 0]]),
        normal=jnp.asarray([[0, 0, 1.0]]),
        material_id=jnp.zeros((1,), jnp.int32),
        geom_index=jnp.zeros((1,), jnp.int32),
    )
    return scene.replace(triangles=tri)


def _many_spheres(n=70):
    """An analytic scene past the fused path's unroll limit (64 prims)."""
    text = CORNELL_SMALL
    desc = parse_scene(text)
    k = desc.num_geoms
    reps = -(-n // k)
    for field in ("geom_type", "material_id", "translation", "rotation",
                  "scale", "transform", "inv_transform", "inv_transpose"):
        v = getattr(desc, field)
        setattr(desc, field, np.concatenate([v] * reps)[:n])
    return Scene.from_desc(desc)


def _scene(kind):
    if kind in ("analytic", "analytic+nee", "throughput+nee"):
        return Scene.from_desc(parse_scene(CORNELL_SMALL))
    if kind == "glass":
        d = load_scene_desc(os.path.join(SCENES, "cornell_glass.txt"))
        d.camera.resolution = (16, 16)
        return Scene.from_desc(d)
    if kind in ("env", "env+nee"):
        d = load_scene_desc(os.path.join(SCENES, "env_spheres.txt"))
        d.camera.resolution = (16, 16)
        return Scene.from_desc(d)
    if kind in ("mesh", "mesh+nee"):
        return _with_triangle(Scene.from_desc(parse_scene(CORNELL_SMALL)))
    if kind == ">64 primitives":
        return _many_spheres()
    raise KeyError(kind)


@pytest.mark.parametrize(
    "kind,config,expected",
    [
        ("analytic", {}, "fast"),
        ("analytic+nee", {"nee": True}, "fast"),
        ("glass", {"enable_refraction": True}, "fast"),
        ("env", {}, "fast"),
        ("env+nee", {"nee": True}, "fast"),
        ("mesh", {}, "reference"),
        ("mesh+nee", {"nee": True}, "reference"),
        (">64 primitives", {}, "reference"),
        ("throughput+nee", {"nee": True, "gather_mode": "throughput"},
         "reference"),
    ],
)
def test_resolve_pipeline_by_scene_class(kind, config, expected):
    """'auto' routes on scene properties alone, the same on every backend."""
    assert RenderConfig(**config).resolve_pipeline(_scene(kind)) == expected


def test_explicit_pipeline_wins():
    scene = _scene("analytic")
    for name in ("fast", "fast_mesh", "reference"):
        assert RenderConfig(pipeline=name).resolve_pipeline(scene) == name


def test_removed_pallas_pipeline_rejected():
    with pytest.raises(ValueError, match="unknown pipeline 'pallas'"):
        RenderConfig(pipeline="pallas").resolve_pipeline(_scene("analytic"))


def test_removed_megakernel_model_rejected():
    from cosc_4397_pathtracing_raytracing_project_tpu.models import (
        make_renderer,
    )

    with pytest.raises(KeyError, match="unknown model 'megakernel'"):
        make_renderer("megakernel", parse_scene(CORNELL_SMALL))


@pytest.mark.parametrize("field,value", [("early_exit", True),
                                         ("env_mode", "split")])
def test_removed_config_fields_rejected(field, value):
    with pytest.raises(TypeError, match=field):
        RenderConfig(**{field: value})


@pytest.mark.parametrize("flags", [["--early-exit"], ["--env-mode", "split"]])
def test_removed_cli_flags_rejected(flags, tmp_path, capsys):
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cli import main

    scene_path = tmp_path / "scene.txt"
    scene_path.write_text(CORNELL_SMALL)
    with pytest.raises(SystemExit) as exc:
        main([str(scene_path)] + flags)
    assert exc.value.code == 2
    assert "unrecognized arguments: " + flags[0] in capsys.readouterr().err
