"""Direct light sampling (next-event estimation).

The reference scans the scene for emissive geoms and uploads their centers
as ``dev_lightPositions`` (`src/pathtrace.cu:454-456,491-504`), passes the
array to the shade kernel (`:340-341`) — and never reads it: direct light
sampling was planned and abandoned, like stream compaction and material
sort. This module is the working version of that capability, rebuilt as
array code: area sampling over the emissive analytic primitives as dense
``[N]``-lane math, one batched shadow-ray intersection per bounce, no
per-light loops.

Estimator (enabled with ``RenderConfig(nee=True)``, ``light_only`` mode
only): at every shading vertex with a diffuse component the contribution

    T · (1 − P_spec) · albedo/π · cosθ_s · cosθ_l · Le · V · w_nee / (d² · pdf_A)

is added, where ``pdf_A`` is the world-space area density of the sampled
light point, and the two techniques that can find direct light through the
diffuse lobe — this sample, and the BRDF-sampled ray happening to hit the
light — are combined with the **balance heuristic** (``w_nee + w_brdf = 1``
per light point; Veach's MIS). Plain NEE alone is *worse* than BRDF
sampling for large nearby lights (the 1/d² factor spikes for surfaces near
the emitter — measured 31.5 vs 32.9 dB on the Cornell box at 64 spp), while
plain BRDF sampling is hopeless for small lights; the balance heuristic
beats both everywhere it was measured: Cornell 38.9 vs 32.9 dB, a 15×
smaller light 26.5 vs 20.4 dB (both 48², 64 spp, vs 1536-spp truth — NEE
carries the far field, BRDF sampling the near-light surfaces, and MIS
takes each where it wins). The specular/glass lobes are
treated as delta distributions: their light hits keep weight 1 and NEE
never competes with them. Off by default — the estimator changes variance,
not the mean, but golden/parity tests pin the reference's exact estimator.

Sampling is uniform over the *object-space* surface of the canonical
primitives; the world-space density follows from the local area scaling of
the affine transform, ``s(x) = |cof(A)·n̂_obj|`` (cofactor transpose is how
normals/areas transform), so non-uniform scales and ellipsoids are handled
exactly — the pdf matches the actual sample density by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import pytree

from ..scene.structs import Scene
from . import linalg
from .intersect import take_rows

_TWO_PI = 6.2831853071795864
_INV_PI = 0.3183098861837907


class LightSampler(pytree.PyTreeNode):
    """Stacked emissive-primitive table (L analytic lights).

    Built from a *concrete* scene (`make_light_sampler`), closed over by the
    render step — the handful of rows become jit constants, the analog of
    the reference's uploaded ``dev_lightPositions`` array."""

    kind: jnp.ndarray  # (L,) i32 — 0 cube, 1 sphere
    transform: jnp.ndarray  # (L, 4, 4) f32
    inv_transpose: jnp.ndarray  # (L, 4, 4) f32
    radiance: jnp.ndarray  # (L, 3) f32 — material color × emittance
    geom_index: jnp.ndarray  # (L,) i32
    num_lights: int = pytree.field(static=True, default=0)

    def sample(self, u: jnp.ndarray):
        """Sample one light point per lane. ``u`` is [N, 3] uniforms
        (pick, surface-a, surface-b). Returns ``(point [N,3], normal [N,3],
        pdf_area [N], radiance [N,3])`` — pdf in world-space area measure,
        including the 1/L light-selection factor."""
        n_lanes = u.shape[0]
        ell = self.num_lights
        pick = jnp.minimum(
            (u[:, 0] * ell).astype(jnp.int32), jnp.int32(ell - 1)
        )
        u_a, u_b = u[:, 1], u[:, 2]

        # per-lane light rows (tables are tiny: one-hot matmul gather)
        m = take_rows(self.transform, pick)
        m_it = take_rows(self.inv_transpose, pick)
        rad = take_rows(self.radiance, pick)
        kind = take_rows(self.kind.astype(jnp.float32)[:, None], pick)[
            :, 0
        ].astype(jnp.int32)

        # ── cube: uniform over the 6 unit-cube faces (object area 6) ──
        face = jnp.minimum((u_a * 6.0).astype(jnp.int32), 5)
        u_f = u_a * 6.0 - face.astype(jnp.float32)  # reclaimed face fraction
        axis = face // 2
        sgn = jnp.where(face % 2 == 0, 1.0, -1.0)
        a_onehot = (
            jnp.arange(3, dtype=jnp.int32)[None, :] == axis[:, None]
        ).astype(jnp.float32)
        # slot layout: the axis slot gets ±0.5, the remaining two (in index
        # order) get the in-face coordinates (cu, cv) — scatter-free
        cu, cv = u_f - 0.5, u_b - 0.5
        in_face = jnp.stack(
            [
                jnp.where(axis == 0, 0.0, cu),
                jnp.where(axis == 1, 0.0, jnp.where(axis == 0, cu, cv)),
                jnp.where(axis == 2, 0.0, cv),
            ],
            axis=-1,
        )
        p_cube = a_onehot * (sgn * 0.5)[:, None] + in_face
        n_cube = a_onehot * sgn[:, None]
        pdf_obj_cube = jnp.float32(1.0 / 6.0)

        # ── sphere: uniform direction, r = 0.5 (object area π) ──
        z = 1.0 - 2.0 * u_a
        r_xy = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
        phi = _TWO_PI * u_b
        n_sph = jnp.stack(
            [r_xy * jnp.cos(phi), z, r_xy * jnp.sin(phi)], axis=-1
        )
        p_sph = 0.5 * n_sph
        pdf_obj_sph = jnp.float32(_INV_PI)

        is_sphere = (kind == 1)[:, None]
        p_obj = jnp.where(is_sphere, p_sph, p_cube)
        n_obj = jnp.where(is_sphere, n_sph, n_cube)
        pdf_obj = jnp.where(kind == 1, pdf_obj_sph, pdf_obj_cube)

        point = linalg.transform_point(m, p_obj)
        n_unnorm = linalg.transform_vector(m_it, n_obj)  # cof(A)·n̂ / det(A)
        normal = linalg.normalize(n_unnorm, eps=1e-20)
        # |cof(A)·n̂_obj| = |det(A)| · |A⁻ᵀ·n̂_obj| — local area scale
        det = _det3(m[:, :3, :3])
        scale = jnp.abs(det) * linalg.norm(n_unnorm)
        pdf_area = pdf_obj / (jnp.float32(ell) * jnp.maximum(scale, 1e-20))
        return point, normal, pdf_area, rad

    def area_pdf_at(self, geom_index: jnp.ndarray, normal_world: jnp.ndarray):
        """World-area density this sampler assigns to a point on light
        ``geom_index`` whose surface normal there is ``normal_world`` — the
        MIS counterpart of :meth:`sample`. Returns ``(pdf_area [N],
        sampled [N] bool)``; ``sampled`` is False for geoms this sampler
        does not cover (pdf then 0)."""
        match = geom_index[:, None] == self.geom_index[None, :]
        sampled = jnp.any(match, axis=1)
        pick = jnp.argmax(match, axis=1).astype(jnp.int32)
        m = take_rows(self.transform, pick)
        m_it = take_rows(self.inv_transpose, pick)
        kind = take_rows(self.kind.astype(jnp.float32)[:, None], pick)[
            :, 0
        ].astype(jnp.int32)
        # invert the normal transform: n_world ∝ A⁻ᵀ·n_obj ⇒ n̂_obj ∝ Aᵀ·n_world
        a = m[:, :3, :3]
        # HIGHEST: a GPU may run a default-precision einsum as TF32
        n_obj = linalg.normalize(
            jnp.einsum(
                "nji,nj->ni", a, normal_world,
                precision=jax.lax.Precision.HIGHEST,
            ),
            eps=1e-20,
        )
        s = jnp.abs(_det3(a)) * linalg.norm(
            linalg.transform_vector(m_it, n_obj)
        )
        pdf_obj = jnp.where(
            kind == 1, jnp.float32(_INV_PI), jnp.float32(1.0 / 6.0)
        )
        pdf = pdf_obj / (
            jnp.float32(self.num_lights) * jnp.maximum(s, 1e-20)
        )
        return jnp.where(sampled, pdf, 0.0), sampled


def _det3(a: jnp.ndarray) -> jnp.ndarray:
    """Determinant of [..., 3, 3] without lax.linalg (stays fusable)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def make_light_sampler(scene: Scene) -> Optional[LightSampler]:
    """Collect the emissive analytic geoms of a *concrete* scene (the same
    scan as `pathtrace.cu:491-504`, but producing sampleable primitives, not
    dead centers). Returns None when the scene has no analytic emitters.
    Raises on emissive triangles: the mesh pipeline keeps BRDF-sampling its
    emitters, and silently not sampling them here would bias the estimator
    (their diffuse-branch hits would be suppressed but never re-added)."""
    emit = np.asarray(scene.materials.emittance)
    rows = []
    for kind_id, batch in ((0, scene.cubes), (1, scene.spheres)):
        mids = np.asarray(batch.material_id)
        for i in np.nonzero(emit[mids] > 0.0)[0]:
            rows.append(
                (
                    kind_id,
                    np.asarray(batch.transform[i]),
                    np.asarray(batch.inv_transpose[i]),
                    np.asarray(scene.materials.color[mids[i]]) * emit[mids[i]],
                    int(np.asarray(batch.geom_index[i])),
                )
            )
    if scene.triangles.count:
        tri_mids = np.asarray(scene.triangles.material_id)
        if np.any(emit[tri_mids] > 0.0):
            raise ValueError(
                "nee: emissive triangles are not sampleable yet — "
                "use analytic (cube/sphere) lights or disable nee"
            )
    if not rows:
        return None
    kinds, tfs, its, rads, gids = zip(*rows)
    return LightSampler(
        kind=jnp.asarray(kinds, jnp.int32),
        transform=jnp.asarray(np.stack(tfs), jnp.float32),
        inv_transpose=jnp.asarray(np.stack(its), jnp.float32),
        radiance=jnp.asarray(np.stack(rads), jnp.float32),
        geom_index=jnp.asarray(gids, jnp.int32),
        num_lights=len(rows),
    )


@dataclasses.dataclass
class NEEInputs:
    """Per-bounce NEE wiring passed into ``shade_step``."""

    sampler: LightSampler
    shadow_isect: Callable  # (origins [N,3], dirs [N,3]) -> Hit
    uniforms: jnp.ndarray  # [N, 3] — light pick + 2 surface coords
