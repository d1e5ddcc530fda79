"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
from cosc_4397_pathtracing_raytracing_project_tpu.parallel import (
    make_mesh,
    make_sharded_step,
    pixel_sharding,
    render_chunk_sharded,
)
from cosc_4397_pathtracing_raytracing_project_tpu.render.state import RenderState
from cosc_4397_pathtracing_raytracing_project_tpu.scene import Scene, parse_scene

from test_render import CORNELL_SMALL


@pytest.fixture(scope="module")
def small_scene():
    return Scene.from_desc(parse_scene(CORNELL_SMALL))


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("sp,dp_note", [(1, "pure pixel tiling"), (2, "sp×dp"), (8, "pure sample parallel")])
def test_sharded_chunk_runs(small_scene, sp, dp_note):
    mesh = make_mesh(8, sample_parallel=sp)
    state = RenderState.create(small_scene.camera.pixel_count, seed=3)
    state = jax.device_put(
        state, state.accum.sharding
    )  # default; accum gets resharded by jit
    cfg = RenderConfig(trace_depth=4)
    new_state = render_chunk_sharded(small_scene, state, cfg, 8, mesh)
    accum = np.asarray(new_state.accum)
    assert accum.shape == (64 * 64, 3)
    assert np.isfinite(accum).all()
    assert accum.max() > 0
    assert int(new_state.iteration) == 8


def test_sharded_matches_single_device_statistics(small_scene):
    """Sharded and single-device renders draw different random streams but
    must agree in expectation: mean image brightness within a few percent
    with enough samples."""
    cfg = RenderConfig(trace_depth=6)
    mesh = make_mesh(8, sample_parallel=2)
    state = RenderState.create(small_scene.camera.pixel_count, seed=0)
    sharded = render_chunk_sharded(small_scene, state, cfg, 32, mesh)

    from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import render_chunk

    single = render_chunk(small_scene, state, cfg, 32)

    img_a = np.asarray(sharded.accum) / 32
    img_b = np.asarray(single.accum) / 32
    assert abs(img_a.mean() - img_b.mean()) / img_b.mean() < 0.05
    # structural agreement: bright/dark layout correlates strongly
    corr = np.corrcoef(img_a.mean(-1).ravel(), img_b.mean(-1).ravel())[0, 1]
    assert corr > 0.95


def test_sharded_sobol_matches_single_device(small_scene):
    """sampler='sobol' under the sharded step: LD draws are keyed by GLOBAL
    pixel id (pixel_offset threads through), so an sp-tiled render draws
    the same first-vertex lattice a full-frame render would; deep bounces
    stay per-shard streams, so agreement is statistical like the
    independent sampler's."""
    cfg = RenderConfig(trace_depth=4, antialias=True, sampler="sobol")
    mesh = make_mesh(8, sample_parallel=2)
    state = RenderState.create(small_scene.camera.pixel_count, seed=0)
    sharded = render_chunk_sharded(small_scene, state, cfg, 32, mesh)

    from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import render_chunk

    single = render_chunk(small_scene, state, cfg, 32)
    img_a = np.asarray(sharded.accum) / 32
    img_b = np.asarray(single.accum) / 32
    assert abs(img_a.mean() - img_b.mean()) / img_b.mean() < 0.05
    corr = np.corrcoef(img_a.mean(-1).ravel(), img_b.mean(-1).ravel())[0, 1]
    assert corr > 0.95


def test_jitted_sharded_step(small_scene):
    mesh = make_mesh(8, sample_parallel=2)
    step = make_sharded_step(small_scene, RenderConfig(trace_depth=4), 4, mesh)
    state = RenderState.create(small_scene.camera.pixel_count, seed=1)
    out = step(small_scene, state)
    assert int(out.iteration) == 4
    out2 = step(small_scene, out)
    assert int(out2.iteration) == 8
    # accumulation is monotone for a nonnegative integrand
    assert np.asarray(out2.accum).sum() >= np.asarray(out.accum).sum()


def test_output_sharding_layout(small_scene):
    mesh = make_mesh(8, sample_parallel=1)
    step = make_sharded_step(small_scene, RenderConfig(trace_depth=2), 2, mesh)
    state = RenderState.create(small_scene.camera.pixel_count, seed=1)
    out = step(small_scene, state)
    # accumulator must remain sharded over dp — no implicit full gather
    shard_shapes = {s.data.shape for s in out.accum.addressable_shards}
    assert shard_shapes == {(64 * 64 // 8, 3)}


from test_fast_mesh import tri_scene  # noqa: E402  (fixture reuse)


@pytest.mark.slow
def test_sharded_mesh_pipeline_matches_single_device(tri_scene):
    """The triangle-mesh pipeline inside shard_map: dp pixel slices through
    trace_sample_mesh + the BVH intersector must match the single-device
    render to float reassociation (1-2 ulp; XLA fuses the differently-shaped
    per-shard graphs differently). RNG keys on global pixel ids, so the
    sampled paths are identical."""
    from cosc_4397_pathtracing_raytracing_project_tpu.parallel import (
        make_sharded_mesh_step,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast
    from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
        make_mesh_intersector,
    )

    # antialias on: the sub-pixel jitter must also be pixel-keyed (a
    # lane-keyed jitter would repeat the same pattern in every shard)
    cfg = RenderConfig(trace_depth=3, sky_strength=0.5, antialias=True)
    num_samples = 2
    state = RenderState.create(tri_scene.camera.pixel_count, seed=0)

    tri_isect = make_mesh_intersector(tri_scene)
    single = jnp.zeros((tri_scene.camera.pixel_count, 3))
    for i in range(num_samples):
        single = single + fast.trace_sample_mesh(
            tri_scene, cfg, state.key, state.iteration + 1 + i, tri_isect
        )
    single = np.asarray(single)

    mesh = make_mesh(4, sample_parallel=1, devices=jax.devices()[:4])
    step = make_sharded_mesh_step(tri_scene, cfg, num_samples, mesh)
    out = step(tri_scene, state)
    assert int(out.iteration) == num_samples
    np.testing.assert_allclose(
        np.asarray(out.accum), single, rtol=3e-7, atol=1e-7
    )


def test_indivisible_configs_raise(small_scene):
    mesh = make_mesh(8, sample_parallel=2)
    state = RenderState.create(small_scene.camera.pixel_count, seed=0)
    with pytest.raises(ValueError):
        render_chunk_sharded(small_scene, state, RenderConfig(), 3, mesh)
    with pytest.raises(ValueError):
        make_mesh(8, sample_parallel=3)


@pytest.mark.slow  # second sharded mesh compile
def test_sharded_mesh_dof_nee_matches_single_device(tri_scene):
    """DOF + NEE composed under shard_map on the mesh pipeline: the lens
    uniforms and the NEE uniforms are both PIXEL-keyed, and the prev_pdf
    MIS register rides the sort payloads, so dp slices must reproduce the
    single-device render to float reassociation."""
    from cosc_4397_pathtracing_raytracing_project_tpu.parallel import (
        make_sharded_mesh_step,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast
    from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
        make_light_sampler,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
        make_mesh_intersector,
    )

    cam = tri_scene.camera.replace(
        aperture=jnp.float32(0.5), focal=jnp.float32(6.0)
    )
    scene = tri_scene.replace(camera=cam)
    cfg = RenderConfig(trace_depth=3, sky_strength=0.5, dof=True, nee=True)
    num_samples = 2
    state = RenderState.create(scene.camera.pixel_count, seed=0)

    tri_isect = make_mesh_intersector(scene)
    sampler = make_light_sampler(scene)
    single = jnp.zeros((scene.camera.pixel_count, 3))
    for i in range(num_samples):
        single = single + fast.trace_sample_mesh(
            scene, cfg, state.key, state.iteration + 1 + i, tri_isect,
            light_sampler=sampler,
        )
    single = np.asarray(single)
    assert np.isfinite(single).all()

    mesh = make_mesh(4, sample_parallel=1, devices=jax.devices()[:4])
    step = make_sharded_mesh_step(scene, cfg, num_samples, mesh)
    out = step(scene, state)
    np.testing.assert_allclose(
        np.asarray(out.accum), single, rtol=3e-7, atol=1e-7
    )


def test_sharded_env_nee_matches_single_device(tmp_path):
    """Environment-map scenes (HDR sky + env NEE) shard over the pixel/
    sample mesh: the EnvMap pytree replicates with the scene and the env
    estimator agrees with the single-device fast pipeline statistically."""
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import write_hdr
    import os

    img = np.full((8, 16, 3), 0.08, np.float32)
    img[2, 5] = [60.0, 50.0, 40.0]  # hard sun: exercises importance sampling
    write_hdr(str(tmp_path / "sun.hdr"), img)
    text = CORNELL_SMALL.replace("EMITTANCE   5", "EMITTANCE   0")
    text = "ENVIRONMENT\nFILE sun.hdr\nSTRENGTH 1\n\n" + text
    scene = Scene.from_desc(parse_scene(text, base_dir=str(tmp_path)))
    assert scene.envmap is not None

    cfg = RenderConfig(trace_depth=4, nee=True)
    mesh = make_mesh(8, sample_parallel=2)
    state = RenderState.create(scene.camera.pixel_count, seed=5)
    sharded = render_chunk_sharded(scene, state, cfg, 16, mesh)

    from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
        render_chunk,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
        make_light_sampler,
    )

    single = render_chunk(
        scene, state, cfg, 16, light_sampler=make_light_sampler(scene)
    )
    img_a = np.asarray(sharded.accum) / 16
    img_b = np.asarray(single.accum) / 16
    assert np.isfinite(img_a).all() and img_a.max() > 0
    assert abs(img_a.mean() - img_b.mean()) / img_b.mean() < 0.05
    corr = np.corrcoef(img_a.mean(-1).ravel(), img_b.mean(-1).ravel())[0, 1]
    assert corr > 0.95

