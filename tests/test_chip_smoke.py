"""chip_smoke.py: refuses a CPU device, and its comparison helpers.

The card-only checks (the script's phases) carry the ``gpu`` marker."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_refuses_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_block_mean_shapes_and_values():
    img = np.arange(32 * 32 * 3, dtype=np.float32).reshape(32, 32, 3)
    bm = chip_smoke.block_mean(img, 8)
    assert bm.shape == (4, 4, 3)
    np.testing.assert_allclose(bm[0, 0], img[:8, :8].mean(axis=(0, 1)))
    # ragged edges are dropped, not padded
    assert chip_smoke.block_mean(img[:30, :31], 8).shape == (3, 3, 3)


def test_agreement_at_32x32():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0.1, 1.0, (32, 32, 3))
    rel, corr = chip_smoke.agreement(ref, ref)
    assert rel == 0.0 and corr == pytest.approx(1.0)
    rel, corr = chip_smoke.agreement(ref * 1.05, ref)
    assert rel == pytest.approx(0.05) and corr == pytest.approx(1.0)
    assert "corr" in chip_smoke.check_agreement("same", ref, ref)
    with pytest.raises(chip_smoke.CheckFailed, match="mean rel diff"):
        chip_smoke.check_agreement("brighter", ref * 1.05, ref)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check_agreement("unrelated", rng.uniform(0.1, 1, ref.shape),
                                   ref)


def test_golden_psnr_at_32x32():
    rng = np.random.default_rng(1)
    ref_u8 = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    linear = (ref_u8.astype(np.float64) / 255.0)[:, ::-1, :]  # save mirror
    assert chip_smoke.golden_psnr(linear, ref_u8) > 200.0
    noisy = np.clip(linear + 0.1, 0, 1)
    mse = ((np.clip(linear + 0.1, 0, 1) - linear) ** 2).mean()
    assert chip_smoke.golden_psnr(noisy, ref_u8) == pytest.approx(
        10 * np.log10(1 / mse), rel=1e-6
    )


def test_rays_per_second_definition():
    assert chip_smoke.rays_per_second(800 * 800, 500, 2.0) == 800 * 800 * 250


def test_triangulated_cornell_routes_to_mesh_pipeline():
    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Scene
    from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast

    desc = chip_smoke._triangulated_cornell_desc()
    desc.camera.resolution = (16, 16)
    scene = Scene.from_desc(desc)
    assert scene.triangles.count % 12 == 0 and scene.triangles.count > 0
    assert scene.cubes.count >= 1  # the light stays analytic
    # the scene the sharded mesh step takes ('auto' picks 'reference')
    assert fast.supports_mesh(scene)
    assert RenderConfig().resolve_pipeline(scene) == "reference"


@pytest.mark.gpu
def test_parity_on_card(gpu):
    smoke = chip_smoke.Smoke()
    assert "corr" in chip_smoke.phase_parity(smoke, n_rays=1 << 16, spp=64)


@pytest.mark.gpu
def test_cornell_on_card(gpu):
    smoke = chip_smoke.Smoke()
    assert "rays/s" in chip_smoke.phase_cornell(smoke, spp=100)
