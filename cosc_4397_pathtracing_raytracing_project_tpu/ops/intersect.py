"""Ray-primitive intersection ops (vectorized, two-phase).

Replicates the semantics of the reference's object-space analytic tests
(`src/intersections.h:48-144`): rays are transformed into the canonical frame
(unit cube [-0.5,0.5]^3 / sphere r=0.5), the object-space hit parameter backs
off by 1e-4 (`getPointOnRay`, `intersections.h:27-29`), and the returned ``t``
is the *world-space distance* from the ray origin to the (backed-off) hit
point, which is what candidate hits are compared by (`pathtrace.cu:314`).

Array design: instead of one divergent thread per ray branching over
primitive types (`pathtrace.cu:311-313`), primitives are partitioned by type
into dense batches and tested as ``[N, K]`` array ops. Phase 1 computes only
the candidate distances; phase 2 gathers the winning primitive's matrices via
a one-hot matmul (dense for the small tables involved) and reconstructs
the hit point / normal for the winner only — avoiding ``K×`` memory traffic
for per-candidate normals.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.pytree import PyTreeNode

from ..scene.structs import GeomBatch, Scene, TriangleBatch
from . import linalg

_BACKOFF = 1e-4  # getPointOnRay epsilon (`intersections.h:28`)
_FMAX = 3.402823466e38  # FLT_MAX, as in the reference slab test
_MISS = 1e30  # internal sentinel for "no hit" distances


class Hit(PyTreeNode):
    """SoA intersection record (`ShadeableIntersection`, `sceneStructs.h:75-83`).

    ``t`` is the world-space distance (>= 0 when hit); misses are flagged by
    ``miss`` and carry ``t = _MISS``."""

    t: jnp.ndarray  # (N,) f32
    point: jnp.ndarray  # (N, 3) f32
    normal: jnp.ndarray  # (N, 3) f32
    material_id: jnp.ndarray  # (N,) i32
    geom_index: jnp.ndarray  # (N,) i32 (original scene OBJECT id; -1 on miss)
    outside: jnp.ndarray  # (N,) bool — ray origin outside the primitive
    miss: jnp.ndarray  # (N,) bool


def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather rows of a small table per ray via one-hot matmul.

    ``table``: (K, ...), ``idx``: (N,) int32 → (N, ...). For the small tables
    here (K = a few dozen primitives / materials) a one-hot contraction is a
    dense matmul. It must run at HIGHEST precision: a GPU's default may be
    TF32 (10 mantissa bits), which would round the gathered matrices."""
    k = table.shape[0]
    flat = table.reshape(k, -1).astype(jnp.float32)
    onehot = (idx[:, None] == jnp.arange(k, dtype=idx.dtype)[None, :]).astype(
        jnp.float32
    )
    out = jnp.dot(
        onehot,
        flat,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape((idx.shape[0],) + table.shape[1:])


def _to_object_space(
    inv: jnp.ndarray, origins: jnp.ndarray, directions: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Transform rays into object space; directions renormalized as in
    `intersections.h:51-52,106-107`. Broadcasts (N,1,…) vs (K,…)→(N,K,3),
    or elementwise for matched leading dims."""
    o = linalg.transform_point(inv, origins)
    d = linalg.normalize(linalg.transform_vector(inv, directions))
    return o, d


# ─────────────────────────────── cubes ───────────────────────────────


def _cube_slabs(q_o: jnp.ndarray, q_d: jnp.ndarray):
    """Slab test in canonical-cube space. Returns (t_obj, hit, outside,
    axis_min_onehot_signed, axis_max_onehot_signed) with the reference's exact
    tie-breaking and IEEE edge-case behavior (`intersections.h:54-84`)."""
    t1 = (-0.5 - q_o) / q_d
    t2 = (0.5 - q_o) / q_d
    ta = jnp.minimum(t1, t2)
    tb = jnp.maximum(t1, t2)
    sign = jnp.where(t2 < t1, 1.0, -1.0)  # n[xyz] per `intersections.h:66`
    # tmin: max over axes of ta where ta > 0 (strict '>' keeps first argmax,
    # NaN/negative lanes excluded) — mirrors the sequential update loop.
    ta_eff = jnp.where(ta > 0, ta, -_FMAX)
    tmin = jnp.max(ta_eff, axis=-1)
    axis_min = jnp.argmax(ta_eff, axis=-1)
    # tmax: min over axes of tb with NaN/+inf lanes excluded exactly as the
    # reference's 'tb < tmax' comparison (false for NaN and +inf vs FLT_MAX).
    tb_eff = jnp.where(tb < _FMAX, tb, _FMAX)
    tmax = jnp.min(tb_eff, axis=-1)
    axis_max = jnp.argmin(tb_eff, axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    outside = tmin > 0
    t_obj = jnp.where(outside, tmin, tmax)
    axis = jnp.where(outside, axis_min, axis_max)
    onehot = (
        jnp.arange(3, dtype=axis.dtype)[None, :]
        == axis[..., None]
    ).astype(jnp.float32)
    normal_obj = onehot * jnp.take_along_axis(sign, axis[..., None], axis=-1)
    return t_obj, hit, outside, normal_obj


def cube_candidate_t(
    batch: GeomBatch, origins: jnp.ndarray, directions: jnp.ndarray
) -> jnp.ndarray:
    """Phase 1: world-space hit distances vs every cube. (N, K), miss=_MISS."""
    q_o, q_d = _to_object_space(
        batch.inv_transform[None, :], origins[:, None], directions[:, None]
    )
    t_obj, hit, _, _ = _cube_slabs(q_o, q_d)
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    p_world = linalg.transform_point(batch.transform[None, :], p_obj)
    t_world = linalg.norm(origins[:, None] - p_world)
    return jnp.where(hit, t_world, _MISS)


def cube_hit_detail(
    transform: jnp.ndarray,
    inv_transform: jnp.ndarray,
    inv_transpose: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
):
    """Phase 2: (point, normal, outside) per ray for per-ray cube matrices."""
    q_o, q_d = _to_object_space(inv_transform, origins, directions)
    t_obj, _, outside, normal_obj = _cube_slabs(q_o, q_d)
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    point = linalg.transform_point(transform, p_obj)
    normal = linalg.normalize(linalg.transform_vector(inv_transpose, normal_obj))
    return point, normal, outside


# ─────────────────────────────── spheres ───────────────────────────────


def _sphere_quadratic(q_o: jnp.ndarray, q_d: jnp.ndarray):
    """Canonical r=0.5 sphere quadratic (`intersections.h:113-133`)."""
    v_dot_d = linalg.dot(q_o, q_d)
    radicand = v_dot_d * v_dot_d - (linalg.dot(q_o, q_o) - 0.25)
    sq = jnp.sqrt(jnp.maximum(radicand, 0.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    outside = both_pos
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    hit = (radicand >= 0) & ~both_neg
    return t_obj, hit, outside


def sphere_candidate_t(
    batch: GeomBatch, origins: jnp.ndarray, directions: jnp.ndarray
) -> jnp.ndarray:
    """Phase 1: world-space hit distances vs every sphere. (N, K)."""
    q_o, q_d = _to_object_space(
        batch.inv_transform[None, :], origins[:, None], directions[:, None]
    )
    t_obj, hit, _ = _sphere_quadratic(q_o, q_d)
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    p_world = linalg.transform_point(batch.transform[None, :], p_obj)
    t_world = linalg.norm(origins[:, None] - p_world)
    return jnp.where(hit, t_world, _MISS)


def sphere_hit_detail(
    transform: jnp.ndarray,
    inv_transform: jnp.ndarray,
    inv_transpose: jnp.ndarray,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
):
    q_o, q_d = _to_object_space(inv_transform, origins, directions)
    t_obj, _, outside = _sphere_quadratic(q_o, q_d)
    p_obj = q_o + (t_obj[..., None] - _BACKOFF) * q_d
    point = linalg.transform_point(transform, p_obj)
    normal = linalg.normalize(linalg.transform_vector(inv_transpose, p_obj))
    normal = jnp.where(outside[..., None], normal, -normal)
    return point, normal, outside


# ─────────────────────────────── triangles ───────────────────────────────


def triangle_candidate_t(
    tris: TriangleBatch, origins: jnp.ndarray, directions: jnp.ndarray
) -> jnp.ndarray:
    """Möller–Trumbore vs every triangle. (N, T). World-space throughout
    (mesh extension; no reference counterpart)."""
    eps = jnp.float32(1e-9)
    d = directions[:, None]  # (N,1,3)
    pvec = linalg.cross(d, tris.e2[None, :])
    det = linalg.dot(tris.e1[None, :], pvec)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = origins[:, None] - tris.v0[None, :]
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, tris.e1[None, :])
    v = linalg.dot(d, qvec) * inv_det
    t = linalg.dot(tris.e2[None, :], qvec) * inv_det
    hit = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > _BACKOFF)
    )
    return jnp.where(hit, t, _MISS)


# ─────────────────────────────── scene-level ───────────────────────────────


def intersect_scene(
    scene: Scene, origins: jnp.ndarray, directions: jnp.ndarray
) -> Hit:
    """Nearest-hit query over all primitives (the computeIntersections kernel,
    `src/pathtrace.cu:288-333`, minus BVH culling — see ops.bvh for that)."""
    kc = scene.cubes.count
    ks = scene.spheres.count
    kt = scene.triangles.count
    n = origins.shape[0]

    cand = []
    if kc:
        cand.append(cube_candidate_t(scene.cubes, origins, directions))
    if ks:
        cand.append(sphere_candidate_t(scene.spheres, origins, directions))

    point = jnp.zeros((n, 3), jnp.float32)
    normal = jnp.zeros((n, 3), jnp.float32)
    outside = jnp.zeros((n,), bool)
    best_t = jnp.full((n,), _MISS)
    material_id = jnp.zeros((n,), jnp.int32)
    geom_index = jnp.full((n,), -1, jnp.int32)

    if kc or ks:
        t_analytic = jnp.concatenate(cand, axis=1)  # (N, Ka)
        best_idx = jnp.argmin(t_analytic, axis=1).astype(jnp.int32)
        best_t = jnp.min(t_analytic, axis=1)
        transform = jnp.concatenate(
            [b.transform for b in (scene.cubes, scene.spheres) if b.count], axis=0
        )
        inv_tf = jnp.concatenate(
            [b.inv_transform for b in (scene.cubes, scene.spheres) if b.count],
            axis=0,
        )
        inv_tp = jnp.concatenate(
            [b.inv_transpose for b in (scene.cubes, scene.spheres) if b.count],
            axis=0,
        )
        mat_ids = jnp.concatenate(
            [b.material_id for b in (scene.cubes, scene.spheres) if b.count], axis=0
        )
        geo_ids = jnp.concatenate(
            [b.geom_index for b in (scene.cubes, scene.spheres) if b.count], axis=0
        )
        m_t = take_rows(transform, best_idx)
        m_i = take_rows(inv_tf, best_idx)
        m_n = take_rows(inv_tp, best_idx)
        if kc and ks:
            c_point, c_normal, c_outside = cube_hit_detail(
                m_t, m_i, m_n, origins, directions
            )
            s_point, s_normal, s_outside = sphere_hit_detail(
                m_t, m_i, m_n, origins, directions
            )
            is_sphere = best_idx >= kc
            point = jnp.where(is_sphere[:, None], s_point, c_point)
            normal = jnp.where(is_sphere[:, None], s_normal, c_normal)
            outside = jnp.where(is_sphere, s_outside, c_outside)
        elif kc:
            point, normal, outside = cube_hit_detail(
                m_t, m_i, m_n, origins, directions
            )
        else:
            point, normal, outside = sphere_hit_detail(
                m_t, m_i, m_n, origins, directions
            )
        material_id = take_rows(
            mat_ids.astype(jnp.float32)[:, None], best_idx
        )[:, 0].astype(jnp.int32)
        geom_index = take_rows(
            geo_ids.astype(jnp.float32)[:, None], best_idx
        )[:, 0].astype(jnp.int32)

    if kt:
        t_tri = triangle_candidate_t(scene.triangles, origins, directions)
        tri_best_idx = jnp.argmin(t_tri, axis=1).astype(jnp.int32)
        tri_best_t = jnp.min(t_tri, axis=1)
        tri_n = take_rows(scene.triangles.normal, tri_best_idx)
        facing = linalg.dot(directions, tri_n) < 0
        tri_n = jnp.where(facing[:, None], tri_n, -tri_n)
        tri_point = origins + (tri_best_t[:, None] - _BACKOFF) * directions
        tri_mat = take_rows(
            scene.triangles.material_id.astype(jnp.float32)[:, None], tri_best_idx
        )[:, 0].astype(jnp.int32)
        tri_geo = take_rows(
            scene.triangles.geom_index.astype(jnp.float32)[:, None], tri_best_idx
        )[:, 0].astype(jnp.int32)
        tri_wins = tri_best_t < best_t
        point = jnp.where(tri_wins[:, None], tri_point, point)
        normal = jnp.where(tri_wins[:, None], tri_n, normal)
        outside = jnp.where(tri_wins, facing, outside)
        material_id = jnp.where(tri_wins, tri_mat, material_id)
        geom_index = jnp.where(tri_wins, tri_geo, geom_index)
        best_t = jnp.minimum(best_t, tri_best_t)

    miss = best_t >= _MISS
    geom_index = jnp.where(miss, -1, geom_index)
    return Hit(
        t=best_t,
        point=point,
        normal=normal,
        material_id=material_id,
        geom_index=geom_index,
        outside=outside,
        miss=miss,
    )
