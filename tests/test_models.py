"""Model registry + wavefront compaction correctness."""

import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig
from cosc_4397_pathtracing_raytracing_project_tpu.models import (
    available_models,
    make_renderer,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene

from test_render import CORNELL_SMALL


def test_registry_lists_reference_configs():
    models = available_models()
    for name in ("naive", "shared", "bvh", "wavefront"):
        assert name in models
    assert "megakernel" not in models


@pytest.mark.parametrize("model", ["naive", "shared", "bvh", "wavefront"])
def test_models_render(model):
    desc = parse_scene(CORNELL_SMALL)
    r = make_renderer(model, desc, RenderConfig(samples_per_launch=4), seed=9)
    r.render(8)
    img = r.linear_image()
    assert np.isfinite(img).all()
    assert img.max() > 0.05


@pytest.mark.parametrize("compaction", ["sort_alive", "sort_material"])
def test_compaction_preserves_image(compaction):
    """Reordering paths between bounces must not change the estimator:
    RNG is pixel-keyed, and the final gather scatters by pixel index."""
    desc = parse_scene(CORNELL_SMALL)
    base = make_renderer(
        "wavefront", desc, RenderConfig(samples_per_launch=8), seed=3,
        compaction="none",
    )
    sorted_r = make_renderer(
        "wavefront", desc, RenderConfig(samples_per_launch=8), seed=3,
        compaction=compaction,
    )
    base.render(8)
    sorted_r.render(8)
    a = np.asarray(base.state.accum)
    b = np.asarray(sorted_r.state.accum)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_wavefront_matches_plain_pipeline():
    desc = parse_scene(CORNELL_SMALL)
    wave = make_renderer(
        "wavefront", desc, RenderConfig(samples_per_launch=8), seed=3
    )
    naive = make_renderer("naive", desc, RenderConfig(samples_per_launch=8), seed=3)
    wave.render(8)
    naive.render(8)
    a = np.asarray(wave.state.accum)
    b = np.asarray(naive.state.accum)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
