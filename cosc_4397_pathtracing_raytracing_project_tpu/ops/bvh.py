"""BVH construction + stackless device traversal.

Host build replicates the reference exactly (`src/pathtrace.cu:23-111`):
per-primitive world AABBs from the 8 transformed unit-cube corners
(`computeBounds`, `:34-50` — also used for spheres, a valid loose bound),
then a recursive median split on the longest axis of the *centroid* bounding
box with primitives sorted by centroid (`buildBVHRecursive`, `:52-99`).
Nodes are emitted in preorder, so the left child is always ``index + 1``.

Traversal redesign: the reference walks the tree with an explicit
per-thread ``int stack[64]`` (`computeIntersections`, `:288-333`). A stack
per lane does not vectorize as whole-array XLA ops, so the tree is
*threaded* instead: each node stores a ``miss_link`` — the preorder successor of its
subtree — and traversal becomes a single forward-moving pointer per lane:

    next = hit_box ? (leaf ? miss : index+1) : miss

executed for all rays as one ``lax.while_loop`` over ``[N]`` arrays with
row-gathers into the flattened node table. Like the reference, no
ordered/near-child descent is performed. Analytic walks do no t-based node
culling either, so their visit set is identical; triangle walks skip boxes
entered beyond the current nearest hit, which never changes the winner
(see ``_traverse``). Results match the brute-force intersector bit-for-bit
(modulo float reassociation).

The AABB slab test replicates ``intersectAABB`` (`:113-128`): tmin starts at
0, tmax at FLT_MAX, slabs swapped by direction sign, miss when
``tmax <= tmin`` — including its IEEE behavior for axis-parallel rays.

If the native C++ builder (native/src/ptruntime.cc) is available it is used for
construction; the NumPy implementation is the reference semantics either way
(both are tested for equivalence).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..scene.structs import Scene
from ..scene.transforms import unit_cube_world_aabb
from . import linalg
from .intersect import (
    _BACKOFF,
    _MISS,
    Hit,
    cube_hit_detail,
    sphere_hit_detail,
)

_FMAX = np.float32(3.402823466e38)

# Primitives per leaf for every traversal here (both intersectors, and
# RenderConfig.bvh_leaf_size's default). Each traversal step runs
# `leaf_size` candidate tests on every lane, so a step's cost grows with
# the leaf faster than the step count falls: on mesh1080p (1920×1080,
# depth 8) on one H100 80GB HBM3 at 700 W, leaf 1 / 2 / 4 ran the
# reference pipeline at 2.59 / 2.07 / 1.66 M rays/s
# (`scripts/bench_mesh.py --compare`).
LEAF_SIZE = 1


# ─────────────────────────── host build ───────────────────────────


@dataclasses.dataclass
class FlatBVH:
    """Flattened, threaded BVH (NumPy, host)."""

    bounds_min: np.ndarray  # (K, 3) f32
    bounds_max: np.ndarray  # (K, 3) f32
    miss_link: np.ndarray  # (K,) i32 — preorder successor of the subtree
    leaf_start: np.ndarray  # (K,) i32 — index into `order`, -1 for internal
    leaf_count: np.ndarray  # (K,) i32
    order: np.ndarray  # (P,) i32 — primitive ids in leaf-contiguous order

    @property
    def num_nodes(self) -> int:
        return int(self.bounds_min.shape[0])


def build_bvh(
    mins: np.ndarray, maxs: np.ndarray, leaf_size: int = 1
) -> FlatBVH:
    """Median-split build (reference algorithm, generalized leaf size)."""
    n = mins.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    mins = np.asarray(mins, np.float32)
    maxs = np.asarray(maxs, np.float32)
    centroids = (mins + maxs) * 0.5

    bmin, bmax, lstart, lcount = [], [], [], []
    order: list = []

    # Preorder recursion; parents union their children's bounds after both
    # subtrees are emitted (`pathtrace.cu:95-98`).
    def rec(indices: np.ndarray) -> int:
        node = len(bmin)
        bmin.append(None)
        bmax.append(None)
        lstart.append(-1)
        lcount.append(0)
        if len(indices) <= leaf_size:
            bmin[node] = mins[indices].min(axis=0)
            bmax[node] = maxs[indices].max(axis=0)
            lstart[node] = len(order)
            lcount[node] = len(indices)
            order.extend(int(i) for i in indices)
            return node
        cent = centroids[indices]
        extent = cent.max(axis=0) - cent.min(axis=0)
        # axis pick per `pathtrace.cu:79-80`
        if extent[0] > extent[1] and extent[0] > extent[2]:
            axis = 0
        elif extent[1] > extent[2]:
            axis = 1
        else:
            axis = 2
        indices = indices[np.argsort(cent[:, axis], kind="stable")]
        mid = len(indices) // 2
        left = rec(indices[:mid])
        right = rec(indices[mid:])
        bmin[node] = np.minimum(bmin[left], bmin[right])
        bmax[node] = np.maximum(bmax[left], bmax[right])
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        rec(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    k = len(bmin)
    bounds_min = np.stack(bmin).astype(np.float32)
    bounds_max = np.stack(bmax).astype(np.float32)
    leaf_start = np.asarray(lstart, np.int32)
    leaf_count = np.asarray(lcount, np.int32)

    # miss link of a node = end of its preorder subtree (next node to visit
    # when the node's box is missed, or after a leaf is tested)
    subtree_end = np.zeros(k, np.int32)

    def mark_ends(node: int) -> int:
        if leaf_start[node] >= 0:
            subtree_end[node] = node + 1
            return node + 1
        left_end = mark_ends(node + 1)
        right_end = mark_ends(left_end)
        subtree_end[node] = right_end
        return right_end

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 4 * n + 100))
    mark_ends(0)
    miss_link = subtree_end.astype(np.int32)

    return FlatBVH(
        bounds_min=bounds_min,
        bounds_max=bounds_max,
        miss_link=miss_link,
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        order=np.asarray(order, np.int32),
    )


def try_native_build(mins, maxs, leaf_size: int) -> Optional[FlatBVH]:
    """Use the C++ builder when the shared library is present."""
    try:
        from ..native import runtime as native_runtime

        out = native_runtime.build_bvh(mins, maxs, leaf_size)
    except Exception:
        return None
    if out is None:
        return None
    bmin, bmax, left, right, start, count, order = out
    k = bmin.shape[0]
    # native emits preorder with explicit subtree ends in `right`
    return FlatBVH(
        bounds_min=bmin,
        bounds_max=bmax,
        miss_link=right.astype(np.int32),
        leaf_start=start.astype(np.int32),
        leaf_count=count.astype(np.int32),
        order=order.astype(np.int32),
    )


# ─────────────────────────── scene packing ───────────────────────────


def scene_analytic_aabbs(scene: Scene) -> Tuple[np.ndarray, np.ndarray]:
    """8-corner world AABBs for the analytic prims (cubes then spheres)."""
    transforms = np.concatenate(
        [
            np.asarray(scene.cubes.transform),
            np.asarray(scene.spheres.transform),
        ],
        axis=0,
    )
    mins = np.zeros((transforms.shape[0], 3), np.float32)
    maxs = np.zeros_like(mins)
    for i in range(transforms.shape[0]):
        mins[i], maxs[i] = unit_cube_world_aabb(transforms[i])
    return mins, maxs


class BVHIntersector:
    """Callable nearest-hit query using threaded-BVH traversal.

    Analytic primitives (cubes + spheres) share one BVH; triangles get their
    own (they are a mesh extension with world-space data)."""

    def __init__(self, scene: Scene, leaf_size: int = LEAF_SIZE):
        self.leaf_size = leaf_size
        kc, ks = scene.cubes.count, scene.spheres.count
        self._has_analytic = (kc + ks) > 0
        if self._has_analytic:
            mins, maxs = scene_analytic_aabbs(scene)
            bvh = try_native_build(mins, maxs, leaf_size) or build_bvh(
                mins, maxs, leaf_size
            )
            self.analytic = _device_bvh(bvh)
            order = bvh.order
            # primitive tables in BVH leaf order
            inv = np.concatenate(
                [
                    np.asarray(scene.cubes.inv_transform),
                    np.asarray(scene.spheres.inv_transform),
                ]
            )[order]
            tf = np.concatenate(
                [
                    np.asarray(scene.cubes.transform),
                    np.asarray(scene.spheres.transform),
                ]
            )[order]
            invt = np.concatenate(
                [
                    np.asarray(scene.cubes.inv_transpose),
                    np.asarray(scene.spheres.inv_transpose),
                ]
            )[order]
            mat = np.concatenate(
                [
                    np.asarray(scene.cubes.material_id),
                    np.asarray(scene.spheres.material_id),
                ]
            )[order]
            geo = np.concatenate(
                [
                    np.asarray(scene.cubes.geom_index),
                    np.asarray(scene.spheres.geom_index),
                ]
            )[order]
            is_sphere = (order >= kc).astype(np.int32)
            self.prim_inv = jnp.asarray(inv)
            self.prim_tf = jnp.asarray(tf)
            self.prim_invt = jnp.asarray(invt)
            self.prim_mat = jnp.asarray(mat, jnp.int32)
            self.prim_geo = jnp.asarray(geo, jnp.int32)
            self.prim_is_sphere = jnp.asarray(is_sphere)

        self._has_tris = scene.triangles.count > 0
        if self._has_tris:
            v0 = np.asarray(scene.triangles.v0)
            e1 = np.asarray(scene.triangles.e1)
            e2 = np.asarray(scene.triangles.e2)
            tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2) - 1e-5
            tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2) + 1e-5
            tbvh = try_native_build(tmin, tmax, leaf_size) or build_bvh(
                tmin, tmax, leaf_size
            )
            self.tri_bvh = _device_bvh(tbvh)
            torder = tbvh.order
            self.tri_v0 = jnp.asarray(v0[torder])
            self.tri_e1 = jnp.asarray(e1[torder])
            self.tri_e2 = jnp.asarray(e2[torder])
            self.tri_n = jnp.asarray(np.asarray(scene.triangles.normal)[torder])
            self.tri_mat = jnp.asarray(
                np.asarray(scene.triangles.material_id)[torder], jnp.int32
            )
            self.tri_geo = jnp.asarray(
                np.asarray(scene.triangles.geom_index)[torder], jnp.int32
            )

    # the engine calls intersectors as f(scene, origins, directions)
    def __call__(self, scene: Scene, origins, directions) -> Hit:
        n = origins.shape[0]
        best_t = jnp.full((n,), _MISS)
        best_p = jnp.full((n,), -1, jnp.int32)
        if self._has_analytic:
            best_t, best_p = _traverse(
                self.analytic,
                origins,
                directions,
                lambda pid, mask, o, d: _analytic_candidate_t(self, pid, mask, o, d),
                self.leaf_size,
                best_t,
                best_p,
            )
        tri_t = jnp.full((n,), _MISS)
        tri_p = jnp.full((n,), -1, jnp.int32)
        if self._has_tris:
            tri_t, tri_p = _traverse(
                self.tri_bvh,
                origins,
                directions,
                lambda pid, mask, o, d: _tri_candidate_t(self, pid, mask, o, d),
                self.leaf_size,
                tri_t,
                tri_p,
                cull=True,
            )
        return self._finalize(origins, directions, best_t, best_p, tri_t, tri_p)

    def _finalize(self, origins, directions, best_t, best_p, tri_t, tri_p):
        n = origins.shape[0]
        point = jnp.zeros((n, 3), jnp.float32)
        normal = jnp.zeros((n, 3), jnp.float32)
        outside = jnp.zeros((n,), bool)
        material_id = jnp.zeros((n,), jnp.int32)
        geom_index = jnp.full((n,), -1, jnp.int32)

        if self._has_analytic:
            pid = jnp.maximum(best_p, 0)
            m_tf = jnp.take(self.prim_tf, pid, axis=0)
            m_in = jnp.take(self.prim_inv, pid, axis=0)
            m_it = jnp.take(self.prim_invt, pid, axis=0)
            c_pt, c_n, c_out = cube_hit_detail(m_tf, m_in, m_it, origins, directions)
            s_pt, s_n, s_out = sphere_hit_detail(
                m_tf, m_in, m_it, origins, directions
            )
            is_sph = jnp.take(self.prim_is_sphere, pid) > 0
            point = jnp.where(is_sph[:, None], s_pt, c_pt)
            normal = jnp.where(is_sph[:, None], s_n, c_n)
            outside = jnp.where(is_sph, s_out, c_out)
            material_id = jnp.take(self.prim_mat, pid)
            geom_index = jnp.take(self.prim_geo, pid)

        if self._has_tris:
            tpid = jnp.maximum(tri_p, 0)
            t_n = jnp.take(self.tri_n, tpid, axis=0)
            facing = linalg.dot(directions, t_n) < 0
            t_n = jnp.where(facing[:, None], t_n, -t_n)
            t_pt = origins + (tri_t[:, None] - _BACKOFF) * directions
            tri_wins = tri_t < best_t
            point = jnp.where(tri_wins[:, None], t_pt, point)
            normal = jnp.where(tri_wins[:, None], t_n, normal)
            outside = jnp.where(tri_wins, facing, outside)
            material_id = jnp.where(
                tri_wins, jnp.take(self.tri_mat, tpid), material_id
            )
            geom_index = jnp.where(tri_wins, jnp.take(self.tri_geo, tpid), geom_index)
            best_t = jnp.minimum(best_t, tri_t)

        miss = best_t >= _MISS
        return Hit(
            t=best_t,
            point=point,
            normal=normal,
            material_id=jnp.where(miss, 0, material_id),
            geom_index=jnp.where(miss, -1, geom_index),
            outside=outside,
            miss=miss,
        )


@dataclasses.dataclass(frozen=True)
class _DeviceBVH:
    bounds_min: jnp.ndarray
    bounds_max: jnp.ndarray
    miss_link: jnp.ndarray
    leaf_start: jnp.ndarray
    leaf_count: jnp.ndarray
    num_nodes: int


def _device_bvh(bvh: FlatBVH) -> _DeviceBVH:
    return _DeviceBVH(
        bounds_min=jnp.asarray(bvh.bounds_min),
        bounds_max=jnp.asarray(bvh.bounds_max),
        miss_link=jnp.asarray(bvh.miss_link),
        leaf_start=jnp.asarray(bvh.leaf_start),
        leaf_count=jnp.asarray(bvh.leaf_count),
        num_nodes=bvh.num_nodes,
    )


def _analytic_candidate_t(self: BVHIntersector, pid, mask, origins, directions):
    """World-space candidate distance for analytic prims `pid` ([N] i32)."""
    inv = jnp.take(self.prim_inv, pid, axis=0)
    q_o = linalg.transform_point(inv, origins)
    q_d_raw = linalg.transform_vector(inv, directions)
    nq2 = jnp.sum(q_d_raw * q_d_raw, axis=-1)
    rinv = jax.lax.rsqrt(jnp.maximum(nq2, 1e-30))

    # cube slabs (unnormalized direction; see ops.fast for the algebra)
    with np.errstate(all="ignore"):
        inv_d = 1.0 / q_d_raw
    t1 = (-0.5 - q_o) * inv_d
    t2 = (0.5 - q_o) * inv_d
    ta = jnp.minimum(t1, t2)
    tb = jnp.maximum(t1, t2)
    ta_eff = jnp.where(ta > 0, ta, -np.float32(_FMAX))
    tb_eff = jnp.where(tb < _FMAX, tb, np.float32(_FMAX))
    s_min = jnp.max(ta_eff, axis=-1)
    s_max = jnp.min(tb_eff, axis=-1)
    cube_hit = (s_max >= s_min) & (s_max > 0)
    cube_s = jnp.where(s_min > 0, s_min, s_max)

    # sphere quadratic
    b = jnp.sum(q_o * q_d_raw, axis=-1)
    c = jnp.sum(q_o * q_o, axis=-1) - 0.25
    disc = b * b - nq2 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s1 = (-b + sq) / nq2
    s2 = (-b - sq) / nq2
    both_neg = (s1 < 0) & (s2 < 0)
    both_pos = (s1 > 0) & (s2 > 0)
    sph_s = jnp.where(both_pos, jnp.minimum(s1, s2), jnp.maximum(s1, s2))
    sph_hit = (disc >= 0) & ~both_neg

    is_sph = jnp.take(self.prim_is_sphere, pid) > 0
    hit = jnp.where(is_sph, sph_hit, cube_hit)
    s = jnp.where(is_sph, sph_s, cube_s)
    t_world = s - _BACKOFF * rinv
    return jnp.where(hit & mask & (t_world > 0), t_world, _MISS)


def _tri_candidate_t(self: BVHIntersector, pid, mask, origins, directions):
    v0 = jnp.take(self.tri_v0, pid, axis=0)
    e1 = jnp.take(self.tri_e1, pid, axis=0)
    e2 = jnp.take(self.tri_e2, pid, axis=0)
    eps = jnp.float32(1e-9)
    pvec = linalg.cross(directions, e2)
    det = linalg.dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = origins - v0
    u = linalg.dot(tvec, pvec) * inv_det
    qvec = linalg.cross(tvec, e1)
    v = linalg.dot(directions, qvec) * inv_det
    t = linalg.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > eps)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > _BACKOFF)
    )
    return jnp.where(hit & mask, t, _MISS)


def _traverse(
    bvh: _DeviceBVH,
    origins,
    directions,
    candidate_fn: Callable,
    leaf_size: int,
    best_t,
    best_p,
    active=None,
    cull: bool = False,
):
    """Threaded stackless traversal over all rays simultaneously.

    `active` ([N] bool, optional) starts dead lanes already finished.
    `cull` also skips boxes entered at or beyond the lane's current nearest
    hit — exact for candidates whose distance is never below their box's
    entry distance (raw triangle t in padded boxes), so the winner is
    unchanged and lanes finish sooner. Analytic candidates are backed off
    from the surface (t − _BACKOFF), which can sit below the entry of a
    neighbouring box, so their traversal does not cull."""
    n = origins.shape[0]
    k = bvh.num_nodes
    inv_d = 1.0 / directions  # IEEE inf for axis-parallel, as the reference

    def cond(state):
        idx, _, _ = state
        return jnp.any(idx < k)

    def body(state):
        idx, best_t, best_p = state
        node = jnp.minimum(idx, k - 1)
        bmin = jnp.take(bvh.bounds_min, node, axis=0)
        bmax = jnp.take(bvh.bounds_max, node, axis=0)
        # intersectAABB (`pathtrace.cu:113-128`): tmin=0, tmax=FLT_MAX
        t0 = (bmin - origins) * inv_d
        t1 = (bmax - origins) * inv_d
        lo = jnp.where(inv_d < 0, t1, t0)
        hi = jnp.where(inv_d < 0, t0, t1)
        tmin = jnp.maximum(jnp.max(lo, axis=-1), 0.0)
        tmax = jnp.minimum(jnp.min(hi, axis=-1), np.float32(_FMAX))
        box_hit = tmax > tmin
        if cull:
            box_hit = box_hit & (tmin < best_t)

        start = jnp.take(bvh.leaf_start, node)
        count = jnp.take(bvh.leaf_count, node)
        is_leaf = start >= 0
        active = idx < k

        test_mask = active & box_hit & is_leaf
        for j in range(leaf_size):
            m = test_mask & (j < count)
            pid = jnp.where(m, jnp.maximum(start, 0) + j, 0)
            t = candidate_fn(pid, m, origins, directions)
            better = t < best_t
            best_t = jnp.where(better, t, best_t)
            best_p = jnp.where(better, pid, best_p)

        miss = jnp.take(bvh.miss_link, node)
        nxt = jnp.where(box_hit & ~is_leaf, idx + 1, miss)
        idx = jnp.where(active, nxt, k)
        return idx, best_t, best_p

    idx0 = jnp.zeros((n,), jnp.int32)
    if active is not None:
        idx0 = jnp.where(active, idx0, k)
    _, best_t, best_p = jax.lax.while_loop(cond, body, (idx0, best_t, best_p))
    return best_t, best_p


def make_bvh_intersector(
    scene: Scene, leaf_size: int = LEAF_SIZE
) -> BVHIntersector:
    return BVHIntersector(scene, leaf_size=leaf_size)


class BVHMeshIntersector:
    """Triangle nearest-hit for the SoA mesh pipeline (ops.fast.
    trace_sample_mesh): the threaded-BVH traversal above, with distance
    culling, behind the component interface the pipeline calls.

    Built from triangle arrays in any order (``v0``/``e1``/``e2`` [T, 3],
    ``material_id`` [T]); the BVH permutes them into leaf order internally
    and reports hits by the caller's index. ``t`` is the raw Möller–Trumbore
    distance of a hit (``> _BACKOFF``), ``_MISS`` when nothing is hit.

    Same traversal, leaf size and culling as BVHIntersector's triangle
    walk (the reference pipeline's), so the two pipelines differ only in
    what surrounds it."""

    def __init__(self, v0, e1, e2, material_id=None, leaf_size: int = LEAF_SIZE):
        v0 = np.asarray(v0, np.float32)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        mat = (
            np.zeros(len(v0), np.float32)
            if material_id is None
            else np.asarray(material_id, np.float32)
        )
        tmin = np.minimum(np.minimum(v0, v0 + e1), v0 + e2) - 1e-5
        tmax = np.maximum(np.maximum(v0, v0 + e1), v0 + e2) + 1e-5
        bvh = try_native_build(tmin, tmax, leaf_size) or build_bvh(
            tmin, tmax, leaf_size
        )
        order = bvh.order
        self.leaf_size = leaf_size
        self.bvh = _device_bvh(bvh)
        self.tri_v0 = jnp.asarray(v0[order])
        self.tri_e1 = jnp.asarray(e1[order])
        self.tri_e2 = jnp.asarray(e2[order])
        # unnormalized geometric normal e1×e2; normalized per hit
        self.tri_n = jnp.asarray(np.cross(e1, e2)[order])
        self.tri_mat = jnp.asarray(mat[order])
        self.tri_id = jnp.asarray(order, jnp.int32)

    def _nearest(self, ox, oy, oz, dx, dy, dz, active):
        n = ox.shape[0]
        origins = jnp.stack([ox, oy, oz], axis=-1)
        directions = jnp.stack([dx, dy, dz], axis=-1)
        return _traverse(
            self.bvh,
            origins,
            directions,
            lambda pid, mask, o, d: _tri_candidate_t(self, pid, mask, o, d),
            self.leaf_size,
            jnp.full((n,), _MISS),
            jnp.full((n,), -1, jnp.int32),
            active=None if active is None else active.astype(bool),
            cull=True,
        )

    def call_soa(self, ox, oy, oz, dx, dy, dz, active=None):
        """(t, idx, nx, ny, nz, mat_f32) component arrays; idx = -1 on a
        miss. The normal is the unit geometric normal flipped to face the
        incoming ray. Lanes with ``active`` false are not traced (miss)."""
        t, p = self._nearest(ox, oy, oz, dx, dy, dz, active)
        pid = jnp.maximum(p, 0)
        nrm = jnp.take(self.tri_n, pid, axis=0)
        nx, ny, nz = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        facing = jnp.where(dx * nx + dy * ny + dz * nz < 0, 1.0, -1.0)
        r = facing * jax.lax.rsqrt(
            jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-30)
        )
        idx = jnp.where(p >= 0, jnp.take(self.tri_id, pid), -1)
        mat = jnp.take(self.tri_mat, pid)
        return t, idx, nx * r, ny * r, nz * r, mat

    def call_t(self, ox, oy, oz, dx, dy, dz, active=None) -> jnp.ndarray:
        """Nearest-hit distance only (``_MISS`` when nothing is hit) — the
        shadow-ray query."""
        t, _ = self._nearest(ox, oy, oz, dx, dy, dz, active)
        return t
