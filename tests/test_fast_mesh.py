"""SoA mesh pipeline (BVH triangle intersector + shade_soa) vs the reference
pipeline."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig
from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
    make_mesh_intersector,
)
from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
    trace_sample,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene import (
    Scene,
    SceneDesc,
    CameraDesc,
    transforms,
)


@pytest.fixture(scope="module")
def cluster(tri_scene):
    """Module-shared triangle intersector (ops.bvh.BVHMeshIntersector):
    the BVH is built once for all the pipeline tests."""
    return make_mesh_intersector(tri_scene)


@pytest.fixture(scope="module")
def tri_scene(rng_np=None):
    """A small closed-ish scene: emissive cube above a triangulated floor +
    a triangulated box of 12 tris."""
    rng = np.random.default_rng(5)
    tf, inv, invt = transforms.geom_matrices([0, 4, 0], [0, 0, 0], [2, 0.2, 2])
    # floor grid
    n = 7
    xs = np.linspace(-4, 4, n)
    verts = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = [xs[i], 0, xs[j]]
            b = [xs[i + 1], 0, xs[j]]
            c = [xs[i], 0, xs[j + 1]]
            d = [xs[i + 1], 0, xs[j + 1]]
            verts.append([a, b, c])
            verts.append([b, d, c])
    tri = np.asarray(verts, np.float32)
    desc = SceneDesc(
        geom_type=np.array([0], np.int32),
        material_id=np.array([0], np.int32),
        translation=np.array([[0, 4, 0]], np.float32),
        rotation=np.zeros((1, 3), np.float32),
        scale=np.array([[2, 0.2, 2]], np.float32),
        transform=tf[None],
        inv_transform=inv[None],
        inv_transpose=invt[None],
        color=np.array([[1, 1, 1], [0.7, 0.5, 0.3]], np.float32),
        specular_exponent=np.zeros(2, np.float32),
        specular_color=np.zeros((2, 3), np.float32),
        reflectivity=np.zeros(2, np.float32),
        refractive=np.zeros(2, np.float32),
        ior=np.zeros(2, np.float32),
        emittance=np.array([5, 0], np.float32),
        camera=CameraDesc(
            (32, 32), 45.0, np.array([0, 2.5, 9.0]), np.array([0, 1.5, 0.0]),
            np.array([0, 1, 0.0]),
        ),
        tri_vertices=tri,
        tri_material_id=np.full(len(tri), 1, np.int32),
    )
    return Scene.from_desc(desc)


def test_supports_mesh(tri_scene):
    assert fast.supports_mesh(tri_scene)
    assert not fast.supports(tri_scene)


def test_mesh_ray_sort_image_invariant(tri_scene, cluster):
    """Per-bounce ray sorting must not change the image: RNG is keyed by
    pixel id (gathered through the permutation), never by lane position."""
    import dataclasses

    cfg_sorted = RenderConfig(trace_depth=4, sky_strength=0.5, mesh_ray_sort=True)
    cfg_unsorted = dataclasses.replace(cfg_sorted, mesh_ray_sort=False)
    key = jax.random.PRNGKey(7)
    # eager on purpose: one render per config does not repay a compile
    a = fast.trace_sample_mesh(tri_scene, cfg_sorted, key, jnp.int32(1), cluster)
    b = fast.trace_sample_mesh(tri_scene, cfg_unsorted, key, jnp.int32(1), cluster)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_mesh_sobol_sort_image_invariant(tri_scene, cluster):
    """sampler='sobol' on the mesh pipeline: the LD lattice is pixel-keyed
    like the hash stream, so the per-bounce resort stays image-invariant,
    and the first-bounce draws actually change vs the independent sampler."""
    import dataclasses

    cfg = RenderConfig(
        trace_depth=4, sky_strength=0.5, antialias=True, sampler="sobol"
    )
    cfg_unsorted = dataclasses.replace(cfg, mesh_ray_sort=False)
    key = jax.random.PRNGKey(7)
    # eager on purpose — see test_mesh_ray_sort_image_invariant
    a = fast.trace_sample_mesh(tri_scene, cfg, key, jnp.int32(1), cluster)
    b = fast.trace_sample_mesh(tri_scene, cfg_unsorted, key, jnp.int32(1),
                               cluster)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-6, atol=1e-7)
    assert np.isfinite(np.asarray(a)).all()
    c = fast.trace_sample_mesh(
        tri_scene, dataclasses.replace(cfg, sampler="independent"), key,
        jnp.int32(1), cluster,
    )
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_mesh_fused_sort_bit_identical(tri_scene, cluster):
    """mesh_sort_fused (one lax.sort carrying all payloads) must produce the
    exact permutation of the argsort+gather path: stable sort, same key."""
    import dataclasses

    cfg = RenderConfig(trace_depth=4, sky_strength=0.5, mesh_sort_fused=False)
    cfg_fused = dataclasses.replace(cfg, mesh_sort_fused=True)
    key = jax.random.PRNGKey(3)
    # eager on purpose — see test_mesh_ray_sort_image_invariant
    a = fast.trace_sample_mesh(tri_scene, cfg, key, jnp.int32(1), cluster)
    b = fast.trace_sample_mesh(tri_scene, cfg_fused, key, jnp.int32(1), cluster)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_sort_cells_image_invariant(tri_scene, cluster):
    """A finer origin grid (mesh_sort_cells=8) only changes the wavefront
    permutation, never the image: radiance scatters back through pixel ids
    and the intersector keeps a strict nearest-t winner."""
    import dataclasses

    cfg4 = RenderConfig(trace_depth=4, sky_strength=0.5)
    cfg8 = dataclasses.replace(cfg4, mesh_sort_cells=8)
    key = jax.random.PRNGKey(11)
    # eager on purpose — see test_mesh_ray_sort_image_invariant
    a = fast.trace_sample_mesh(tri_scene, cfg4, key, jnp.int32(1), cluster)
    b = fast.trace_sample_mesh(tri_scene, cfg8, key, jnp.int32(1), cluster)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.slow  # ~4 min on CPU; invariance + fused-sort bit-identity
# above cover the mesh path in the fast lap
def test_mesh_pipeline_matches_reference(tri_scene, cluster):
    cfg = RenderConfig(trace_depth=4, sky_strength=0.5)
    key = jax.random.PRNGKey(0)
    n_samples = 6
    # ref path: jit with iteration traced — one compile, then 6 fast
    # executions. The mesh path stays eager.
    ref_fn = jax.jit(lambda s, k, it: trace_sample(s, cfg, k, it))
    acc_mesh = jnp.zeros((tri_scene.camera.pixel_count, 3))
    acc_ref = jnp.zeros_like(acc_mesh)
    for i in range(n_samples):
        acc_mesh = acc_mesh + fast.trace_sample_mesh(
            tri_scene, cfg, key, jnp.int32(1 + i), cluster
        )
        acc_ref = acc_ref + ref_fn(tri_scene, key, jnp.int32(1 + i))
    a = np.asarray(acc_mesh) / n_samples
    b = np.asarray(acc_ref) / n_samples
    assert np.isfinite(a).all()
    # identical RNG streams (both use pixel-indexed [NUM_LANES, n]? no — the
    # reference path draws [n, lanes]); compare statistically
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-9) < 0.15
    corr = np.corrcoef(a.mean(-1), b.mean(-1))[0, 1]
    assert corr > 0.9


def test_mesh_pipeline_dof(tri_scene, cluster):
    """DOF on the mesh pipeline: finite, blurred (differs from pinhole),
    and pinhole is untouched by the gate (dof=False path identical)."""
    key = jax.random.PRNGKey(0)
    cam = tri_scene.camera.replace(
        aperture=jnp.float32(0.8), focal=jnp.float32(6.0)
    )
    sc = tri_scene.replace(camera=cam)
    pin = fast.trace_sample_mesh(
        sc, RenderConfig(trace_depth=3), key, jnp.int32(1), cluster
    )
    blur = fast.trace_sample_mesh(
        sc, RenderConfig(trace_depth=3, dof=True), key, jnp.int32(1), cluster
    )
    a, b = np.asarray(pin), np.asarray(blur)
    assert np.isfinite(b).all()
    assert np.abs(a - b).mean() > 1e-5
    # gate off ignores the camera's aperture entirely (static no-op)
    pin2 = fast.trace_sample_mesh(
        tri_scene, RenderConfig(trace_depth=3), key, jnp.int32(1), cluster
    )
    np.testing.assert_array_equal(a, np.asarray(pin2))


def test_mesh_nee_sort_invariant(tri_scene, cluster):
    """NEE on the mesh pipeline: the per-bounce resort must stay
    image-invariant (pixel-keyed hash NEE uniforms + the prev_pdf MIS
    register riding both sort paths), and fused vs gather sorts must pick
    identical permutations with the extra payload."""
    import dataclasses
    from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
        make_light_sampler,
    )

    sampler = make_light_sampler(tri_scene)
    assert sampler is not None  # the fixture's emissive cube
    key = jax.random.PRNGKey(7)
    base = RenderConfig(trace_depth=4, nee=True, mesh_ray_sort=True,
                        mesh_sort_fused=True)
    a = fast.trace_sample_mesh(tri_scene, base, key, jnp.int32(1), cluster,
                               light_sampler=sampler)
    b = fast.trace_sample_mesh(
        tri_scene, dataclasses.replace(base, mesh_ray_sort=False), key,
        jnp.int32(1), cluster, light_sampler=sampler)
    c = fast.trace_sample_mesh(
        tri_scene, dataclasses.replace(base, mesh_sort_fused=False), key,
        jnp.int32(1), cluster, light_sampler=sampler)
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)
    # NEE actually engages: the direct-light term changes the 1-spp image
    plain = np.asarray(fast.trace_sample_mesh(
        tri_scene, RenderConfig(trace_depth=4), key, jnp.int32(1), cluster))
    assert np.abs(a - plain).mean() > 1e-5


@pytest.mark.slow  # 2 x 12 eager renders
def test_mesh_nee_mean_agrees(tri_scene, cluster):
    """Unbiasedness pin: the mesh NEE estimator's mean matches the plain
    BRDF estimator on the same scene (different variance, same target)."""
    from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
        make_light_sampler,
    )

    sampler = make_light_sampler(tri_scene)
    key = jax.random.PRNGKey(0)
    n_samples = 12
    cfg_nee = RenderConfig(trace_depth=4, nee=True)
    cfg_plain = RenderConfig(trace_depth=4)
    acc_nee = jnp.zeros((tri_scene.camera.pixel_count, 3))
    acc_plain = jnp.zeros_like(acc_nee)
    for i in range(n_samples):
        acc_nee = acc_nee + fast.trace_sample_mesh(
            tri_scene, cfg_nee, key, jnp.int32(1 + i), cluster,
            light_sampler=sampler)
        acc_plain = acc_plain + fast.trace_sample_mesh(
            tri_scene, cfg_plain, key, jnp.int32(1 + i), cluster)
    a = np.asarray(acc_nee).mean() / n_samples
    b = np.asarray(acc_plain).mean() / n_samples
    assert abs(a - b) / max(b, 1e-9) < 0.12


def _random_rays(rng, n):
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 6.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_mesh_intersector_call_soa_matches_brute_force(tri_scene, cluster,
                                                       rng_np):
    """The XLA BVH intersector's call_soa against the all-triangle
    Möller–Trumbore matrix of ops.intersect (same nearest hit, distance,
    ray-facing unit normal and material)."""
    from cosc_4397_pathtracing_raytracing_project_tpu.ops import intersect

    o, d = _random_rays(rng_np, 2048)
    tris = tri_scene.triangles
    cand = np.asarray(
        intersect.triangle_candidate_t(tris, jnp.asarray(o), jnp.asarray(d))
    )
    ref_t, ref_i = cand.min(axis=1), cand.argmin(axis=1)
    hit = ref_t < 1e29
    assert 0.1 < hit.mean() < 0.9  # the ray set exercises hits and misses
    t, idx, nx, ny, nz, mat = (
        np.asarray(x) for x in cluster.call_soa(
            *(jnp.asarray(o[:, i]) for i in range(3)),
            *(jnp.asarray(d[:, i]) for i in range(3)),
        )
    )
    assert np.array_equal(idx >= 0, hit)
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=1e-5, atol=1e-5)
    assert (t[~hit] >= 1e29).all()
    # winner identity (shared edges may tie between neighbours)
    assert (idx[hit] == ref_i[hit]).mean() > 0.99
    n = np.stack([nx, ny, nz], axis=1)[hit]
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    assert ((n * d[hit]).sum(axis=1) <= 1e-6).all()  # faces the ray
    geo = np.asarray(tris.normal)[idx[hit]]
    np.testing.assert_allclose(np.abs((n * geo).sum(axis=1)), 1.0, atol=1e-5)
    np.testing.assert_array_equal(
        mat[hit], np.asarray(tris.material_id)[idx[hit]].astype(np.float32)
    )


def test_mesh_intersector_call_t_and_active_mask(tri_scene, cluster, rng_np):
    """call_t is call_soa's distance; inactive lanes are not traced."""
    o, d = _random_rays(rng_np, 1024)
    cols = [jnp.asarray(o[:, i]) for i in range(3)] + [
        jnp.asarray(d[:, i]) for i in range(3)
    ]
    t_full = np.asarray(cluster.call_soa(*cols)[0])
    np.testing.assert_array_equal(np.asarray(cluster.call_t(*cols)), t_full)
    active = np.arange(1024) % 2 == 0
    t_act = np.asarray(cluster.call_t(*cols, active=jnp.asarray(active)))
    np.testing.assert_array_equal(t_act[active], t_full[active])
    assert (t_act[~active] >= 1e29).all()
