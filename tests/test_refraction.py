"""Refraction extension: a glass sphere between the camera and the light."""

import numpy as np

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene

GLASS_SCENE = """
MATERIAL 0
RGB 1 1 1
SPECEX 0
SPECRGB 0 0 0
REFL 0
REFR 0
REFRIOR 0
EMITTANCE 5

MATERIAL 1
RGB .95 .95 .95
SPECEX 0
SPECRGB 1 1 1
REFL 0
REFR 1
REFRIOR 1.5
EMITTANCE 0

CAMERA
RES 48 48
FOVY 45
ITERATIONS 32
DEPTH 8
FILE glass
EYE 0 0 8
LOOKAT 0 0 0
UP 0 1 0

OBJECT 0
sphere
material 0
TRANS 0 0 -6
ROTAT 0 0 0
SCALE 2 2 2

OBJECT 1
sphere
material 1
TRANS 0 0 0
ROTAT 0 0 0
SCALE 3 3 3
"""


def test_glass_transmits_light():
    desc = parse_scene(GLASS_SCENE)
    on = Renderer(
        desc, RenderConfig(samples_per_launch=16, enable_refraction=True), seed=2
    )
    off = Renderer(
        desc, RenderConfig(samples_per_launch=16, enable_refraction=False), seed=2
    )
    on.render(32)
    off.render(32)
    img_on = on.linear_image()
    img_off = off.linear_image()
    assert np.isfinite(img_on).all()
    # the light sits directly behind the glass sphere; with refraction the
    # center pixels receive transmitted light, without it the sphere's
    # glossy-cone branch scatters them away from the light
    center_on = img_on[20:28, 20:28].mean()
    center_off = img_off[20:28, 20:28].mean()
    assert center_on > 4 * max(center_off, 1e-6)


def test_refraction_supported_on_fast_pipeline():
    """Refraction no longer forces the slow readable pipeline: the SoA fast
    path implements the same Snell+Schlick branch (no 57× cliff for one
    material flag)."""
    desc = parse_scene(GLASS_SCENE)
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene

    cfg = RenderConfig(enable_refraction=True)
    assert cfg.resolve_pipeline(Scene.from_desc(desc)) == "fast"


def test_glass_fast_matches_reference_statistics():
    """fast (shade_soa) and reference (shade_step) glass must agree: same
    estimator, different RNG layout → statistical comparison."""
    desc = parse_scene(GLASS_SCENE)
    ref = Renderer(
        desc,
        RenderConfig(
            samples_per_launch=16, enable_refraction=True, pipeline="reference"
        ),
        seed=2,
    )
    fast = Renderer(
        desc,
        RenderConfig(
            samples_per_launch=16, enable_refraction=True, pipeline="fast"
        ),
        seed=2,
    )
    ref.render(64)
    fast.render(64)
    a = ref.linear_image()
    b = fast.linear_image()
    assert np.isfinite(b).all()
    # transmitted-light hot spot present in both
    assert b[20:28, 20:28].mean() > 4 * max(b[2:6, 2:6].mean(), 1e-6)
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) < 0.15
    corr = np.corrcoef(a.mean(-1).ravel(), b.mean(-1).ravel())[0, 1]
    assert corr > 0.9


def test_refraction_off_preserves_parity_semantics():
    """With the flag off, REFRIOR materials keep the reference meaning
    (hasRefractive = 1 - roughness) and images are unchanged."""
    desc = parse_scene(GLASS_SCENE)
    a = Renderer(desc, RenderConfig(samples_per_launch=8, pipeline="reference"), seed=1)
    b = Renderer(desc, RenderConfig(samples_per_launch=8, pipeline="fast"), seed=1)
    a.render(16)
    b.render(16)
    ia, ib = np.asarray(a.state.accum), np.asarray(b.state.accum)
    assert abs(ia.mean() - ib.mean()) / max(ib.mean(), 1e-9) < 0.25
