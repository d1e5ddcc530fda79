"""Speed-of-light wavefront pipeline (structure-of-arrays fast path).

Semantically equivalent to ops.intersect + ops.shade (same reference
semantics, see those modules for the `pathtrace.cu` / `intersections.h`
citations), re-expressed as elementwise array code that XLA fuses into a
few kernels per bounce — the form of the reference's one-thread-per-path
``computeIntersections`` + ``shadeMaterial`` kernels:

- every quantity is a flat ``[N]`` float32 array (x/y/z as separate arrays):
  unit-stride, coalesced loads per component, no size-3 minor axis;
- the primitive loop is unrolled in Python (static K) with a running
  nearest-hit — no ``[N, K]`` materialization, no gathers: the winning
  normal/material are carried through ``where`` selects;
- the object-space direction is left unnormalized: slab/quadratic parameters
  in that scale convert to the reference's world-space distance as
  ``t_world = s - 1e-4 / |q_d|`` (exact algebra, since M·q_d = d and |d| = 1),
  eliminating the per-candidate world-point transform entirely;
- hit point = ``origin + t_world · direction`` (the same algebra), so phase-2
  is only the winner's normal;
- trig is minimized: cos θ = √(1-u), sin θ = √u replaces acos/sin/cos chains.

The pipeline applies to analytic scenes (cubes + spheres, ≤ MAX_UNROLL
primitives). Mesh/BVH scenes take the general path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.structs import Scene

MAX_UNROLL = 64
_MISS = 1e30
_FMAX = 3.402823466e38
_PI = 3.14159265358979323846
_BACKOFF = 1e-4
_ORIGIN_OFFSET = 1e-3


def supports(scene: Scene) -> bool:
    return (
        scene.triangles.count == 0
        and 0 < scene.cubes.count + scene.spheres.count <= MAX_UNROLL
    )


class _Best(NamedTuple):
    t: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray
    mat: jnp.ndarray  # int32 material id
    miss: jnp.ndarray  # bool
    outside: jnp.ndarray  # bool: hit from outside the primitive (for ior)
    # original scene OBJECT index of the winner — needed only by the NEE
    # MIS weight (lights.area_pdf_at); the mesh path leaves it None
    geom: jnp.ndarray = None


def _rsqrt(x):
    return jax.lax.rsqrt(x)


def _obj_ray(iv, ox, oy, oz, dx, dy, dz):
    """Object-space ray (direction left unnormalized). iv: [4,4] traced."""
    qox = iv[0, 0] * ox + iv[0, 1] * oy + iv[0, 2] * oz + iv[0, 3]
    qoy = iv[1, 0] * ox + iv[1, 1] * oy + iv[1, 2] * oz + iv[1, 3]
    qoz = iv[2, 0] * ox + iv[2, 1] * oy + iv[2, 2] * oz + iv[2, 3]
    qdx = iv[0, 0] * dx + iv[0, 1] * dy + iv[0, 2] * dz
    qdy = iv[1, 0] * dx + iv[1, 1] * dy + iv[1, 2] * dz
    qdz = iv[2, 0] * dx + iv[2, 1] * dy + iv[2, 2] * dz
    return qox, qoy, qoz, qdx, qdy, qdz


def _world_normal(it, nox, noy, noz):
    """invTranspose · n_obj, normalized."""
    wx = it[0, 0] * nox + it[0, 1] * noy + it[0, 2] * noz
    wy = it[1, 0] * nox + it[1, 1] * noy + it[1, 2] * noz
    wz = it[2, 0] * nox + it[2, 1] * noy + it[2, 2] * noz
    r = _rsqrt(wx * wx + wy * wy + wz * wz)
    return wx * r, wy * r, wz * r


def _cube_test(iv, it, ox, oy, oz, dx, dy, dz):
    """Unit-cube slab test, reference tie-breaking (first-max / first-min).
    Returns (t_world, hit, nx, ny, nz)."""
    qox, qoy, qoz, qdx, qdy, qdz = _obj_ray(iv, ox, oy, oz, dx, dy, dz)
    rinv = _rsqrt(qdx * qdx + qdy * qdy + qdz * qdz)

    ix = 1.0 / qdx
    iy = 1.0 / qdy
    iz = 1.0 / qdz
    t1x = (-0.5 - qox) * ix
    t2x = (0.5 - qox) * ix
    t1y = (-0.5 - qoy) * iy
    t2y = (0.5 - qoy) * iy
    t1z = (-0.5 - qoz) * iz
    t2z = (0.5 - qoz) * iz
    tax = jnp.minimum(t1x, t2x)
    tbx = jnp.maximum(t1x, t2x)
    tay = jnp.minimum(t1y, t2y)
    tby = jnp.maximum(t1y, t2y)
    taz = jnp.minimum(t1z, t2z)
    tbz = jnp.maximum(t1z, t2z)
    sx = jnp.where(t2x < t1x, 1.0, -1.0)
    sy = jnp.where(t2y < t1y, 1.0, -1.0)
    sz = jnp.where(t2z < t1z, 1.0, -1.0)

    ax = jnp.where(tax > 0, tax, -_FMAX)
    ay = jnp.where(tay > 0, tay, -_FMAX)
    az = jnp.where(taz > 0, taz, -_FMAX)
    bx = jnp.where(tbx < _FMAX, tbx, _FMAX)
    by = jnp.where(tby < _FMAX, tby, _FMAX)
    bz = jnp.where(tbz < _FMAX, tbz, _FMAX)

    s_min = jnp.maximum(ax, jnp.maximum(ay, az))
    s_max = jnp.minimum(bx, jnp.minimum(by, bz))

    # first-max axis for entry face, first-min for exit face
    min_is_x = (ax >= ay) & (ax >= az)
    min_is_y = ~min_is_x & (ay >= az)
    max_is_x = (bx <= by) & (bx <= bz)
    max_is_y = ~max_is_x & (by <= bz)

    outside = s_min > 0
    hit = (s_max >= s_min) & (s_max > 0)
    s = jnp.where(outside, s_min, s_max)

    use_x = jnp.where(outside, min_is_x, max_is_x)
    use_y = jnp.where(outside, min_is_y, max_is_y)
    nox = jnp.where(use_x, sx, 0.0)
    noy = jnp.where(use_y, sy, 0.0)
    noz = jnp.where(use_x | use_y, 0.0, sz)

    t_world = s - _BACKOFF * rinv
    nx, ny, nz = _world_normal(it, nox, noy, noz)
    return t_world, hit, nx, ny, nz, outside


def _sphere_test(iv, it, ox, oy, oz, dx, dy, dz):
    """Canonical r=0.5 sphere quadratic (unnormalized direction form)."""
    qox, qoy, qoz, qdx, qdy, qdz = _obj_ray(iv, ox, oy, oz, dx, dy, dz)
    a = qdx * qdx + qdy * qdy + qdz * qdz
    rinv = _rsqrt(a)
    b = qox * qdx + qoy * qdy + qoz * qdz
    c = qox * qox + qoy * qoy + qoz * qoz - 0.25
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    s1 = (-b + sq) * inv_a
    s2 = (-b - sq) * inv_a
    both_neg = (s1 < 0) & (s2 < 0)
    both_pos = (s1 > 0) & (s2 > 0)
    outside = both_pos
    s = jnp.where(both_pos, jnp.minimum(s1, s2), jnp.maximum(s1, s2))
    hit = (disc >= 0) & ~both_neg
    t_world = s - _BACKOFF * rinv
    # object-space hit point (with backoff) = q_o + t_world * q_d
    pnx = qox + t_world * qdx
    pny = qoy + t_world * qdy
    pnz = qoz + t_world * qdz
    nx, ny, nz = _world_normal(it, pnx, pny, pnz)
    flip = jnp.where(outside, 1.0, -1.0)
    return t_world, hit, nx * flip, ny * flip, nz * flip, outside


def intersect_unrolled(scene: Scene, ox, oy, oz, dx, dy, dz) -> _Best:
    """Nearest hit over all primitives, running-winner unrolled loop."""
    n = ox.shape[0]
    best = _Best(
        t=jnp.full((n,), _MISS),
        nx=jnp.zeros((n,)),
        ny=jnp.zeros((n,)),
        nz=jnp.zeros((n,)),
        mat=jnp.zeros((n,), jnp.int32),
        miss=jnp.ones((n,), bool),
        outside=jnp.ones((n,), bool),
        geom=jnp.full((n,), -1, jnp.int32),
    )

    def consider(best, t, hit, nx, ny, nz, mat_id, outside, geom_id):
        better = hit & (t > 0) & (t < best.t)
        return _Best(
            t=jnp.where(better, t, best.t),
            nx=jnp.where(better, nx, best.nx),
            ny=jnp.where(better, ny, best.ny),
            nz=jnp.where(better, nz, best.nz),
            mat=jnp.where(better, mat_id, best.mat),
            miss=best.miss & ~better,
            outside=(best.outside & ~better) | (outside & better),
            geom=jnp.where(better, geom_id, best.geom),
        )

    for k in range(scene.cubes.count):
        t, hit, nx, ny, nz, outside = _cube_test(
            scene.cubes.inv_transform[k],
            scene.cubes.inv_transpose[k],
            ox, oy, oz, dx, dy, dz,
        )
        best = consider(
            best, t, hit, nx, ny, nz, scene.cubes.material_id[k], outside,
            scene.cubes.geom_index[k],
        )
    for k in range(scene.spheres.count):
        t, hit, nx, ny, nz, outside = _sphere_test(
            scene.spheres.inv_transform[k],
            scene.spheres.inv_transpose[k],
            ox, oy, oz, dx, dy, dz,
        )
        best = consider(
            best, t, hit, nx, ny, nz, scene.spheres.material_id[k], outside,
            scene.spheres.geom_index[k],
        )
    return best


def _select_material(materials, mat_id):
    """Unrolled per-lane material fetch (material constants fold into the
    fused kernel — the analog of the reference's shared-memory material
    cache)."""
    m = materials.color.shape[0]
    fields = dict(
        cr=0.0, cg=0.0, cb=0.0, sr=0.0, sg=0.0, sb=0.0, refl=0.0, refr=0.0,
        emit=0.0, ior=0.0,
    )
    out = {k: jnp.zeros_like(mat_id, dtype=jnp.float32) for k in fields}
    for i in range(m):
        sel = mat_id == i
        out["cr"] = jnp.where(sel, materials.color[i, 0], out["cr"])
        out["cg"] = jnp.where(sel, materials.color[i, 1], out["cg"])
        out["cb"] = jnp.where(sel, materials.color[i, 2], out["cb"])
        out["sr"] = jnp.where(sel, materials.specular_color[i, 0], out["sr"])
        out["sg"] = jnp.where(sel, materials.specular_color[i, 1], out["sg"])
        out["sb"] = jnp.where(sel, materials.specular_color[i, 2], out["sb"])
        out["refl"] = jnp.where(sel, materials.reflectivity[i], out["refl"])
        out["refr"] = jnp.where(sel, materials.refractive[i], out["refr"])
        out["emit"] = jnp.where(sel, materials.emittance[i], out["emit"])
        out["ior"] = jnp.where(sel, materials.ior[i], out["ior"])
    return out


def _local_frame(vx, vy, vz):
    """createLocalCoordinateSystem, componentwise (`pathtrace.cu:216-223`)."""
    use_a = jnp.abs(vx) > jnp.abs(vy)
    tx = jnp.where(use_a, vz, 0.0)
    ty = jnp.where(use_a, 0.0, -vz)
    tz = jnp.where(use_a, -vx, vy)
    r = _rsqrt(jnp.maximum(tx * tx + ty * ty + tz * tz, 1e-20))
    tx, ty, tz = tx * r, ty * r, tz * r
    bx = vy * tz - vz * ty
    by = vz * tx - vx * tz
    bz = vx * ty - vy * tx
    return tx, ty, tz, bx, by, bz


def _thin_lens_soa(cam, ox, oy, oz, dx, dy, dz, u1, u2):
    """Componentwise thin-lens transform of pinhole rays (ops.camera.
    thin_lens in SoA form — DOF extension, no reference analog). The
    pinhole direction is traced to the focal plane; the origin jitters to
    a concentric lens-disk sample of radius cam.aperture in the
    (right, up) plane and the direction re-aims at the pierce point."""
    ct = dx * cam.view[0] + dy * cam.view[1] + dz * cam.view[2]
    ft = cam.focal / jnp.maximum(ct, 1e-6)
    fx = ox + dx * ft
    fy = oy + dy * ft
    fz = oz + dz * ft
    r = cam.aperture * jnp.sqrt(u1)
    th = (2.0 * jnp.pi) * u2
    lx = r * jnp.cos(th)
    ly = r * jnp.sin(th)
    ox = ox + cam.right[0] * lx + cam.up[0] * ly
    oy = oy + cam.right[1] * lx + cam.up[1] * ly
    oz = oz + cam.right[2] * lx + cam.up[2] * ly
    ndx = fx - ox
    ndy = fy - oy
    ndz = fz - oz
    rn = _rsqrt(jnp.maximum(ndx * ndx + ndy * ndy + ndz * ndz, 1e-20))
    return ox, oy, oz, ndx * rn, ndy * rn, ndz * rn


def trace_sample_fast(
    scene: Scene,
    config,
    base_key,
    iteration,
    pixel_offset=0,
    num_pixels=None,
    light_sampler=None,
    pixels=None,
):
    """Full per-sample wavefront (raygen → bounce loop → radiance), SoA.

    Returns an [N, 3] radiance (light_only) or terminal-throughput
    (throughput mode) image contribution, matching render.engine.trace_sample.
    With ``config.nee`` a ``light_sampler`` (ops.lights.make_light_sampler
    on the concrete scene) must be supplied; direct light sampling + MIS
    then runs per bounce, estimator-identical to ops.shade.shade_step's
    nee branch (componentwise SoA form). Environment-map scenes
    (scene.envmap) swap the gradient sky for the HDR lookup and, with
    ``config.nee``, importance-sample the map (ops/envmap.py) — the SoA
    twin of shade_step's env branches.

    ``pixels`` ([N] int32 global pixel ids, any order, repeats allowed)
    traces those pixels instead of a contiguous slice; ``iteration`` may
    then be an [N] array (one sample index per lane), and every random
    draw is keyed by (pixel, iteration) alone, so a pixel's sample stream
    is independent of which lane traces it (render.adaptive's tiles)."""
    from . import rng as rng_ops

    cam = scene.camera
    w, h = cam.resolution
    keyed = pixels is not None
    if keyed:
        n = pixels.shape[0]
    else:
        n = num_pixels if num_pixels is not None else cam.pixel_count
    legacy = config.gather_mode == "throughput"
    env = scene.envmap
    want_nee = bool(getattr(config, "nee", False))
    use_area_nee = want_nee and light_sampler is not None
    use_env_nee = want_nee and env is not None
    use_nee = use_area_nee or use_env_nee
    if use_nee and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
    if want_nee and not use_nee:
        raise ValueError(
            "config.nee=True needs a light_sampler "
            "(ops.lights.make_light_sampler on the concrete scene) or an "
            "ENVIRONMENT map"
        )

    # sampler='sobol': first-vertex dimensions draw per-pixel shifted
    # (0,2)-sequence points, keyed by GLOBAL pixel id (shard slices see the
    # same stream a full-frame render would); deeper bounces stay threefry.
    use_ld = getattr(config, "sampler", "independent") == "sobol"

    if keyed:
        idx = pixels.astype(jnp.int32)
        cam_u = rng_ops.hash_camera_uniforms(base_key, iteration, idx)
    else:
        idx = pixel_offset + jnp.arange(n, dtype=jnp.int32)
    px = (idx % w).astype(jnp.float32)
    py = (idx // w).astype(jnp.float32)
    if config.antialias:
        if use_ld:
            jit2 = rng_ops.ld_pixel_jitter(base_key, iteration, idx)
        elif keyed:
            jit2 = cam_u[:, 0:2]
        else:
            jit2 = rng_ops.pixel_jitter(base_key, iteration, n)
        px = px + jit2[:, 0]
        py = py + jit2[:, 1]
    sx = cam.pixel_length[0] * (px - 0.5 * w)
    sy = cam.pixel_length[1] * (py - 0.5 * h)
    dx = cam.view[0] - cam.right[0] * sx - cam.up[0] * sy
    dy = cam.view[1] - cam.right[1] * sx - cam.up[1] * sy
    dz = cam.view[2] - cam.right[2] * sx - cam.up[2] * sy
    r = _rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * r, dy * r, dz * r
    ox = jnp.broadcast_to(cam.position[0], (n,))
    oy = jnp.broadcast_to(cam.position[1], (n,))
    oz = jnp.broadcast_to(cam.position[2], (n,))
    if getattr(config, "dof", False):
        if use_ld:
            lens2 = rng_ops.ld_lens_uniforms(base_key, iteration, idx)
        elif keyed:
            lens2 = cam_u[:, 2:4]
        else:
            lens2 = rng_ops.lens_uniforms(base_key, iteration, n)
        ox, oy, oz, dx, dy, dz = _thin_lens_soa(
            cam, ox, oy, oz, dx, dy, dz, lens2[:, 0], lens2[:, 1]
        )

    ones = jnp.ones((n,), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    carry = (
        ox, oy, oz, dx, dy, dz,
        ones, ones, ones,  # throughput r,g,b
        jnp.full((n,), config.trace_depth, jnp.int32),  # bounces
        zeros, zeros, zeros,  # radiance r,g,b
    )
    if use_nee:
        # solid-angle pdf of the lobe that produced this ray (−1 = delta /
        # primary), for the next emissive hit's MIS weight
        carry = carry + (jnp.full((n,), -1.0, jnp.float32),)

    def bounce(carry, depth, u=None, nee_u=None):
        (ox, oy, oz, dx, dy, dz) = carry[:6]
        if u is None and keyed:
            u = rng_ops.hash_bounce_uniforms(base_key, iteration, depth, idx)
        elif u is None:
            key = rng_ops.bounce_key(base_key, iteration, depth)
            u = jax.random.uniform(key, (rng_ops.NUM_LANES, n), jnp.float32)
        best = intersect_unrolled(scene, ox, oy, oz, dx, dy, dz)
        nee = env_nee = None
        shadow_t = lambda sx, sy, sz, wx, wy, wz: intersect_unrolled(
            scene, sx, sy, sz, wx, wy, wz
        ).t
        if use_area_nee:
            if nee_u is None and keyed:
                nee_u = rng_ops.hash_nee_uniforms(base_key, iteration, depth, idx)
            elif nee_u is None:
                nee_u = rng_ops.nee_uniforms(base_key, iteration, depth, n)
            nee = (light_sampler, shadow_t, nee_u)
        if use_env_nee:
            env_nee = (
                shadow_t,
                rng_ops.hash_env_uniforms(base_key, iteration, depth, idx)
                if keyed
                else rng_ops.env_uniforms(base_key, iteration, depth, n),
            )
        return shade_soa(
            carry, best, u, scene.materials, depth, config, nee=nee,
            env=env, env_nee=env_nee,
        ), None

    start = 0
    if use_ld:
        # LD bounces unrolled out of the scan (per-depth lattices are a
        # static branch, depth is traced inside the scan)
        for d in range(min(getattr(config, "ld_depths", 1), config.trace_depth)):
            carry, _ = bounce(
                carry,
                jnp.int32(d),
                u=rng_ops.ld_bounce_uniforms(base_key, iteration, idx, d),
                nee_u=(
                    rng_ops.ld_nee_bounce_uniforms(base_key, iteration, idx, d)
                    if use_nee
                    else None
                ),
            )
            start = d + 1
    carry, _ = jax.lax.scan(
        bounce, carry, jnp.arange(start, config.trace_depth, dtype=jnp.int32)
    )
    (_, _, _, _, _, _, cr, cg, cb, _, rr_, rg_, rb_) = carry[:13]
    if legacy:
        return jnp.stack([cr, cg, cb], axis=-1)
    return jnp.stack([rr_, rg_, rb_], axis=-1)


def shade_soa(carry, best: _Best, u, materials, depth, config, nee=None,
              env=None, env_nee=None):
    """One masked shade/extend pass over SoA component state — the
    componentwise twin of ops.shade.shade_step (same reference semantics).
    `carry` is the 13-tuple wavefront state (14 with `nee`/`env_nee`: a
    trailing prev_pdf register); `u` is [NUM_LANES, N]. `nee` is
    ``(light_sampler, shadow_t_fn, uniforms [N,3])`` — direct light
    sampling + MIS, the SoA twin of shade_step's nee branch. `env` (an
    ops.envmap.EnvMap) swaps the gradient sky for the HDR lookup;
    `env_nee` is ``(shadow_t_fn, uniforms [N,2])`` for environment
    importance sampling + MIS (shade_step's env_nee twin)."""
    (ox, oy, oz, dx, dy, dz, cr, cg, cb, bounces, rr_, rg_, rb_) = carry[:13]
    carry_pdf = nee is not None or env_nee is not None
    prev_pdf = carry[13] if carry_pdf else None
    legacy = config.gather_mode == "throughput"
    u_rr, u_branch, u_a, u_b, u_c = u[0], u[1], u[2], u[3], u[4]

    alive = bounces > 0
    missed = best.miss

    if env is not None:
        from . import envmap as envmap_ops

        dirs3 = jnp.stack([dx, dy, dz], axis=-1)
        sky3 = envmap_ops.env_radiance(env, dirs3)
        sky_r, sky_g, sky_b = sky3[:, 0], sky3[:, 1], sky3[:, 2]
    else:
        # sky (`pathtrace.cu:358-362`)
        t_sky = 0.5 * (dy + 1.0)
        sky_r = ((1.0 - t_sky) + t_sky * 0.5) * 0.5
        sky_g = ((1.0 - t_sky) + t_sky * 0.7) * 0.5
        sky_b = ((1.0 - t_sky) + t_sky * 1.0) * 0.5
    if legacy:
        cr = jnp.where(missed, cr * sky_r, cr)
        cg = jnp.where(missed, cg * sky_g, cg)
        cb = jnp.where(missed, cb * sky_b, cb)
    elif env is not None:
        esc = missed & alive
        w_esc = 1.0
        if env_nee is not None:
            # MIS partner of env importance sampling (see shade_step)
            p_env = envmap_ops.env_pdf(env, dirs3)
            w_esc = jnp.where(
                prev_pdf < 0.0,
                1.0,
                prev_pdf / jnp.maximum(prev_pdf + p_env, 1e-20),
            )
        rr_ = jnp.where(esc, rr_ + cr * sky_r * w_esc, rr_)
        rg_ = jnp.where(esc, rg_ + cg * sky_g * w_esc, rg_)
        rb_ = jnp.where(esc, rb_ + cb * sky_b * w_esc, rb_)
    elif config.sky_strength:
        esc = missed & alive
        ss = jnp.float32(config.sky_strength)
        rr_ = jnp.where(esc, rr_ + cr * sky_r * ss, rr_)
        rg_ = jnp.where(esc, rg_ + cg * sky_g * ss, rg_)
        rb_ = jnp.where(esc, rb_ + cb * sky_b * ss, rb_)

    act = ~missed & alive
    mat = _select_material(materials, best.mat)

    # emissive termination
    emissive = mat["emit"] > 0.0
    hit_light = act & emissive
    if legacy:
        cr = jnp.where(hit_light, cr * mat["cr"] * mat["emit"], cr)
        cg = jnp.where(hit_light, cg * mat["cg"] * mat["emit"], cg)
        cb = jnp.where(hit_light, cb * mat["cb"] * mat["emit"], cb)
    elif nee is not None:
        # MIS balance heuristic (ops/shade.py emissive branch): a
        # BRDF-sampled emissive hit reached via the previous vertex's
        # diffuse lobe competes with NEE having sampled the same point
        sampler = nee[0]
        normal3 = jnp.stack([best.nx, best.ny, best.nz], axis=-1)
        p_nee_area, sampled = sampler.area_pdf_at(best.geom, normal3)
        cos_l = jnp.maximum(
            -(dx * best.nx + dy * best.ny + dz * best.nz), 1e-6
        )
        p_nee_dir = p_nee_area * best.t * best.t / cos_l
        w_emit = jnp.where(
            (prev_pdf < 0.0) | ~sampled,
            1.0,
            prev_pdf / jnp.maximum(prev_pdf + p_nee_dir, 1e-20),
        )
        rr_ = jnp.where(hit_light, rr_ + cr * mat["cr"] * mat["emit"] * w_emit, rr_)
        rg_ = jnp.where(hit_light, rg_ + cg * mat["cg"] * mat["emit"] * w_emit, rg_)
        rb_ = jnp.where(hit_light, rb_ + cb * mat["cb"] * mat["emit"] * w_emit, rb_)
    else:
        rr_ = jnp.where(hit_light, rr_ + cr * mat["cr"] * mat["emit"], rr_)
        rg_ = jnp.where(hit_light, rg_ + cg * mat["cg"] * mat["emit"], rg_)
        rb_ = jnp.where(hit_light, rb_ + cb * mat["cb"] * mat["emit"], rb_)
    act = act & ~emissive

    # Russian roulette
    rr_on = depth > jnp.int32(config.rr_start_depth)
    p_cont = jnp.maximum(mat["cr"], jnp.maximum(mat["cg"], mat["cb"]))
    rr_kill = act & rr_on & (u_rr > p_cont)
    rr_boost = jnp.where(
        act & rr_on & ~rr_kill, 1.0 / jnp.maximum(p_cont, 1e-12), 1.0
    )
    cr, cg, cb = cr * rr_boost, cg * rr_boost, cb * rr_boost
    act = act & ~rr_kill

    # scatter
    nx, ny, nz = best.nx, best.ny, best.nz
    refl = mat["refl"]
    rough = 1.0 - mat["refr"]
    spec = act & (refl > 0.0) & (u_branch < refl)

    # mirror + cone perturb around the reflected direction
    ddn = dx * nx + dy * ny + dz * nz
    rx = dx - 2.0 * ddn * nx
    ry = dy - 2.0 * ddn * ny
    rz = dz - 2.0 * ddn * nz
    ang = rough * u_a * (_PI * 0.5)
    sa = jnp.sin(ang)
    ca = jnp.cos(ang)
    ph_s = 2.0 * _PI * u_c
    cp_s = jnp.cos(ph_s)
    sp_s = jnp.sin(ph_s)
    # cosine-weighted diffuse: cosθ=√(1-u_a), sinθ=√u_a (trig-free polar)
    st = jnp.sqrt(u_a)
    ct = jnp.sqrt(jnp.maximum(1.0 - u_a, 0.0))
    ph_d = 2.0 * _PI * u_b
    cp_d = jnp.cos(ph_d)
    sp_d = jnp.sin(ph_d)
    # A lane is either specular (cone around the reflection r) or diffuse
    # (cosine lobe around the normal n), never both — so select the polar
    # axis and the local-frame coefficients FIRST and build ONE orthonormal
    # frame instead of two. Per lane the arithmetic (values and op order) is
    # exactly what the two-frame form computed, so renders are bit-identical,
    # but a _local_frame, a 9-mul combine and an _rsqrt renormalize drop out.
    vax = jnp.where(spec, rx, nx)
    vay = jnp.where(spec, ry, ny)
    vaz = jnp.where(spec, rz, nz)
    w0 = jnp.where(spec, sa * cp_s, st * cp_d)
    w1 = jnp.where(spec, ca, ct)
    w2 = jnp.where(spec, sa * sp_s, st * sp_d)
    tx, ty, tz, bx, by, bz = _local_frame(vax, vay, vaz)
    ndx = tx * w0 + vax * w1 + bx * w2
    ndy = ty * w0 + vay * w1 + by * w2
    ndz = tz * w0 + vaz * w1 + bz * w2
    rs = _rsqrt(jnp.maximum(ndx * ndx + ndy * ndy + ndz * ndz, 1e-20))
    new_dx = ndx * rs
    new_dy = ndy * rs
    new_dz = ndz * rs
    tint_r = jnp.where(spec, mat["sr"], mat["cr"])
    tint_g = jnp.where(spec, mat["sg"], mat["cg"])
    tint_b = jnp.where(spec, mat["sb"], mat["cb"])

    # Extension: dielectric refraction, componentwise (same semantics as
    # ops.shade.shade_step's enable_refraction branch — Snell + Schlick
    # Fresnel, `pathtrace.cu:244-248` schlickFresnel is defined-but-unused
    # in the reference). Statically gated: off costs nothing.
    push_through = None
    if getattr(config, "enable_refraction", False):
        is_glass = (mat["ior"] > 0.0) & (mat["refr"] > 0.0)
        cos_i = jnp.clip(-(dx * nx + dy * ny + dz * nz), 0.0, 1.0)
        n1 = jnp.where(best.outside, 1.0, mat["ior"])
        n2 = jnp.where(best.outside, mat["ior"], 1.0)
        eta = n1 / jnp.maximum(n2, 1e-6)
        sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
        tir = sin2_t > 1.0
        cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        fres = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
        coef = eta * cos_i - cos_t
        fx_ = eta * dx + coef * nx
        fy_ = eta * dy + coef * ny
        fz_ = eta * dz + coef * nz
        rn_ = _rsqrt(jnp.maximum(fx_ * fx_ + fy_ * fy_ + fz_ * fz_, 1e-20))
        transmit = is_glass & ~tir & (u_branch >= fres)
        glass_mask = act & is_glass
        # transmit → refracted dir; reflect (incl. TIR) → pure mirror r
        gdx = jnp.where(transmit, fx_ * rn_, rx)
        gdy = jnp.where(transmit, fy_ * rn_, ry)
        gdz = jnp.where(transmit, fz_ * rn_, rz)
        new_dx = jnp.where(glass_mask, gdx, new_dx)
        new_dy = jnp.where(glass_mask, gdy, new_dy)
        new_dz = jnp.where(glass_mask, gdz, new_dz)
        tint_r = jnp.where(
            glass_mask, jnp.where(transmit, mat["cr"], mat["sr"]), tint_r
        )
        tint_g = jnp.where(
            glass_mask, jnp.where(transmit, mat["cg"], mat["sg"]), tint_g
        )
        tint_b = jnp.where(
            glass_mask, jnp.where(transmit, mat["cb"], mat["sb"]), tint_b
        )
        push_through = glass_mask & transmit

    # hit point = o + t·d (exact algebra, see module docstring); a
    # transmitted ray steps through the interface instead of off it
    off = (
        _ORIGIN_OFFSET
        if push_through is None
        else jnp.where(push_through, -_ORIGIN_OFFSET, _ORIGIN_OFFSET)
    )
    hx = ox + best.t * dx + nx * off
    hy = oy + best.t * dy + ny * off
    hz = oz + best.t * dz + nz * off

    if nee is not None:
        # ── direct light at this vertex (ops/shade.py NEE block in SoA
        # component form): estimate the diffuse component of the mixture
        # BRDF, (1−P_spec)·albedo/π; cr/cg/cb are the post-RR, pre-tint
        # throughput. The balance-heuristic partner lives at the
        # emissive-hit branch above.
        sampler, shadow_t, nee_u = nee
        inv_pi = jnp.float32(0.3183098861837907)
        # push_through doubles as the "refraction compiled in" marker
        glass = glass_mask if push_through is not None else None
        base = act if glass is None else act & ~glass
        lp, ln, pdf_a, le = sampler.sample(nee_u)
        tox = lp[:, 0] - hx
        toy = lp[:, 1] - hy
        toz = lp[:, 2] - hz
        d2 = tox * tox + toy * toy + toz * toz
        dist = jnp.sqrt(jnp.maximum(d2, 1e-24))
        rdist = 1.0 / dist
        wx, wy, wz = tox * rdist, toy * rdist, toz * rdist
        cos_s = nx * wx + ny * wy + nz * wz
        cos_l2 = -(ln[:, 0] * wx + ln[:, 1] * wy + ln[:, 2] * wz)
        sh_t = shadow_t(hx, hy, hz, wx, wy, wz)
        visible = sh_t >= dist - jnp.maximum(1e-3, 1e-3 * dist)
        add = (base & (cos_s > 0.0) & (cos_l2 > 0.0)
               & (dist > 1e-4) & visible)
        diffuse_prob = 1.0 - refl
        p_brdf_area = (
            diffuse_prob * jnp.maximum(cos_s, 0.0) * inv_pi
            * jnp.maximum(cos_l2, 0.0) / jnp.maximum(d2, 1e-12)
        )
        w_mis = pdf_a / jnp.maximum(pdf_a + p_brdf_area, 1e-20)
        geomf = cos_s * cos_l2 / jnp.maximum(d2 * pdf_a, 1e-20)
        k_d = diffuse_prob * inv_pi * geomf * w_mis
        rr_ = jnp.where(add, rr_ + cr * mat["cr"] * k_d * le[:, 0], rr_)
        rg_ = jnp.where(add, rg_ + cg * mat["cg"] * k_d * le[:, 1], rg_)
        rb_ = jnp.where(add, rb_ + cb * mat["cb"] * k_d * le[:, 2], rb_)

    if env_nee is not None:
        # ── direct environment light (shade_step's env_nee block in SoA
        # form): solid-angle-measure light pdf, visibility = the shadow
        # ray escapes the scene entirely, own MIS pair vs BRDF sampling
        from . import envmap as envmap_ops

        shadow_t, env_u = env_nee
        inv_pi = jnp.float32(0.3183098861837907)
        glass = glass_mask if push_through is not None else None
        base = act if glass is None else act & ~glass
        wi, _len, pdf_e = envmap_ops.sample_env(env, env_u[:, 0], env_u[:, 1])
        # both techniques integrate the SAME bilinear L (see shade_step)
        le3 = envmap_ops.env_radiance(env, wi)
        wx, wy, wz = wi[:, 0], wi[:, 1], wi[:, 2]
        cos_s = nx * wx + ny * wy + nz * wz
        sh_t = shadow_t(hx, hy, hz, wx, wy, wz)
        visible = sh_t >= _MISS  # _MISS sentinel: escaped
        diffuse_prob = 1.0 - refl
        p_brdf = diffuse_prob * jnp.maximum(cos_s, 0.0) * inv_pi
        w_mis = pdf_e / jnp.maximum(pdf_e + p_brdf, 1e-20)
        k_e = (
            diffuse_prob * inv_pi
            * jnp.maximum(cos_s, 0.0) / jnp.maximum(pdf_e, 1e-20) * w_mis
        )
        add = base & (cos_s > 0.0) & visible
        rr_ = jnp.where(add, rr_ + cr * mat["cr"] * k_e * le3[:, 0], rr_)
        rg_ = jnp.where(add, rg_ + cg * mat["cg"] * k_e * le3[:, 1], rg_)
        rb_ = jnp.where(add, rb_ + cb * mat["cb"] * k_e * le3[:, 2], rb_)

    if carry_pdf:
        # density of THIS vertex's lobe choice (next emissive hit's / env
        # escape's MIS): diffuse lanes carry (1−P)·cosθ/π, delta lobes −1
        inv_pi = jnp.float32(0.3183098861837907)
        diffuse_prob = 1.0 - refl
        glass = glass_mask if push_through is not None else None
        cos_new = jnp.maximum(new_dx * nx + new_dy * ny + new_dz * nz, 0.0)
        diffuse_ext = act & ~spec
        if glass is not None:
            diffuse_ext = diffuse_ext & ~glass
        prev_pdf = jnp.where(
            diffuse_ext, diffuse_prob * cos_new * inv_pi, jnp.float32(-1.0)
        )

    cr = jnp.where(act, cr * tint_r, cr)
    cg = jnp.where(act, cg * tint_g, cg)
    cb = jnp.where(act, cb * tint_b, cb)
    ox = jnp.where(act, hx, ox)
    oy = jnp.where(act, hy, oy)
    oz = jnp.where(act, hz, oz)
    dx = jnp.where(act, new_dx, dx)
    dy = jnp.where(act, new_dy, dy)
    dz = jnp.where(act, new_dz, dz)
    bounces = jnp.where(act, bounces - 1, jnp.zeros_like(bounces))

    out = (ox, oy, oz, dx, dy, dz, cr, cg, cb, bounces, rr_, rg_, rb_)
    return out + (prev_pdf,) if carry_pdf else out

def supports_mesh(scene: Scene) -> bool:
    """Mesh SoA pipeline: triangles via a BVH intersector + unrolled
    analytic primitives."""
    return (
        scene.triangles.count > 0
        and scene.cubes.count + scene.spheres.count <= MAX_UNROLL
        and scene.envmap is None
    )


@functools.lru_cache(maxsize=8)
def _block_order(w: int, h: int, block: int = 32) -> np.ndarray:
    """Pixel visit permutation grouping ``block``×``block`` screen rects.

    Linear pixel order puts long runs of *consecutive scanline* pixels
    next to each other — a frustum half the screen wide and one pixel tall.
    Visiting pixels block-by-block makes neighbouring rays a compact screen
    rect, so they walk similar BVH paths. Returned as int32 [w*h]:
    entry i is the linear pixel id the i-th ray handles. Stable argsort
    keeps row-major order inside a block (ragged edge blocks are simply
    smaller)."""
    py, px = np.mgrid[0:h, 0:w]
    bw = (w + block - 1) // block
    key = (py // block) * bw + (px // block)
    return np.argsort(key.ravel(), kind="stable").astype(np.int32)


def trace_sample_mesh(
    scene: Scene,
    config,
    base_key,
    iteration,
    tri_isect,
    pixel_offset=0,
    num_pixels=None,
    light_sampler=None,
):
    """SoA wavefront for triangle-mesh scenes: per bounce, ``tri_isect``
    (ops.bvh.BVHMeshIntersector: winner t/normal/material through
    ``call_soa``, shadow distances through ``call_t``) handles triangles
    and the unrolled loop handles analytic primitives; results merge by
    nearest t and feed the shared shade_soa stage.

    With ``config.nee`` a ``light_sampler`` over the scene's ANALYTIC
    emitters must be supplied; the shadow ray then tests triangles through
    ``tri_isect.call_t`` and analytic primitives through the unrolled loop
    (one extra nearest-hit pass per bounce). Emissive TRIANGLES stay
    BRDF-sampled — the sampler does not cover them, so their MIS weight
    is exactly 1 and the estimator stays unbiased."""
    from . import rng as rng_ops

    cam = scene.camera
    w, h = cam.resolution
    n = num_pixels if num_pixels is not None else cam.pixel_count
    legacy = config.gather_mode == "throughput"
    use_nee = bool(getattr(config, "nee", False))
    if use_nee and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
    if use_nee and light_sampler is None:
        raise ValueError(
            "config.nee=True needs a light_sampler "
            "(ops.lights.make_light_sampler on the concrete scene)"
        )
    has_analytic = scene.cubes.count + scene.spheres.count > 0
    do_sort = getattr(config, "mesh_ray_sort", True) and not legacy
    if do_sort and w * h >= (1 << 24):
        # (global) pixel ids ride the packed [N, 14] f32 gather; from 2^24
        # on they are no longer exactly representable in f32 and radiance
        # would scatter to wrong pixels. 16.7M pixels = beyond 8K frames;
        # use the fused sort (int-native) or tile the frame externally.
        # (No-sort configurations never cast pixel ids to f32.)
        if not getattr(config, "mesh_sort_fused", False):
            raise ValueError(
                f"frames with {w * h} pixels (>= 2^24) need "
                "mesh_sort_fused=True (pixel ids exceed exact f32 range)"
            )
    # Block-ordered primary rays: only when the final unsort already exists
    # (do_sort) and this call renders the full frame (the sharded path hands
    # out scanline slices; blocking a slice would need its own unsort).
    blocked = (
        do_sort and isinstance(pixel_offset, int) and pixel_offset == 0
        and n == w * h
    )
    if blocked:
        local = jnp.asarray(_block_order(w, h))
        idx = local
    else:
        local = jnp.arange(n, dtype=jnp.int32)
        idx = pixel_offset + local
    px = (idx % w).astype(jnp.float32)
    py = (idx // w).astype(jnp.float32)
    # sampler='sobol': LD draws are pixel-keyed hashes of the GLOBAL id
    # already — no full-frame generate+gather needed, any ray order or
    # shard slice reads its own lattice rows directly.
    use_ld = getattr(config, "sampler", "independent") == "sobol"
    if config.antialias:
        if use_ld:
            jit2 = rng_ops.ld_pixel_jitter(base_key, iteration, idx)
        else:
            # jitter is PIXEL-keyed: generate the full frame's rows and
            # gather by global pixel id whenever ray i ≠ pixel i (block
            # order or a dp shard slice) — lane-position rows would repeat
            # the same jitter pattern in every shard. Full-frame direct
            # indexing skips the identity gather.
            direct = not blocked and num_pixels is None
            jit2 = rng_ops.pixel_jitter(base_key, iteration, w * h)
            if not direct:
                jit2 = jnp.take(jit2, idx, axis=0)
        px = px + jit2[:, 0]
        py = py + jit2[:, 1]
    sx = cam.pixel_length[0] * (px - 0.5 * w)
    sy = cam.pixel_length[1] * (py - 0.5 * h)
    dx = cam.view[0] - cam.right[0] * sx - cam.up[0] * sy
    dy = cam.view[1] - cam.right[1] * sx - cam.up[1] * sy
    dz = cam.view[2] - cam.right[2] * sx - cam.up[2] * sy
    r = _rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * r, dy * r, dz * r
    ox = jnp.broadcast_to(cam.position[0], (n,))
    oy = jnp.broadcast_to(cam.position[1], (n,))
    oz = jnp.broadcast_to(cam.position[2], (n,))
    if getattr(config, "dof", False):
        if use_ld:
            lens2 = rng_ops.ld_lens_uniforms(base_key, iteration, idx)
        else:
            # PIXEL-keyed like the jitter above: block order / shard slices
            # get the same lens sample for a pixel as a full-frame render
            direct = not blocked and num_pixels is None
            lens2 = rng_ops.lens_uniforms(base_key, iteration, w * h)
            if not direct:
                lens2 = jnp.take(lens2, idx, axis=0)
        ox, oy, oz, dx, dy, dz = _thin_lens_soa(
            cam, ox, oy, oz, dx, dy, dz, lens2[:, 0], lens2[:, 1]
        )

    ones = jnp.ones((n,), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    carry = (
        ox, oy, oz, dx, dy, dz,
        ones, ones, ones,
        jnp.full((n,), config.trace_depth, jnp.int32),
        zeros, zeros, zeros,
    )
    if use_nee:
        # prev-lobe solid-angle pdf for MIS (−1 = delta/primary), appended
        # LAST so slots 0-12 keep their layout for the sort payloads
        carry = carry + (jnp.full((n,), -1.0, jnp.float32),)
    # Ray i carries its GLOBAL pixel id through reorders: the per-bounce
    # hash uniforms key on it, so dp shards rendering different slices draw
    # decorrelated streams (local ids would repeat across shards), and a
    # sharded render is bit-identical per pixel to the single-device one.
    # The final unsort argsort(pixel) is offset-invariant (monotonic shift).
    pixel = idx

    # scene bounds for the origin-cell sort key
    cells = int(getattr(config, "mesh_sort_cells", 4))
    if getattr(config, "mesh_ray_sort", True):
        lo = jnp.minimum(
            scene.triangles.v0.min(axis=0),
            jnp.minimum(
                (scene.triangles.v0 + scene.triangles.e1).min(axis=0),
                (scene.triangles.v0 + scene.triangles.e2).min(axis=0),
            ),
        )
        hi = jnp.maximum(
            scene.triangles.v0.max(axis=0),
            jnp.maximum(
                (scene.triangles.v0 + scene.triangles.e1).max(axis=0),
                (scene.triangles.v0 + scene.triangles.e2).max(axis=0),
            ),
        )
        cell_scale = float(cells) / jnp.maximum(hi - lo, 1e-3)

    def sort_rays(carry, pixel):
        """Reorder the wavefront by (origin cell, direction octant) so
        neighbouring rays stay coherent on incoherent secondary bounces.
        Image-invariant because radiance scatters back through pixel
        indices at the end (finalGather architecture)."""
        (ox, oy, oz, dx, dy, dz, cr, cg, cb, bounces,
         rr_, rg_, rb_) = carry[:13]
        prev = carry[13] if use_nee else None
        alive = bounces > 0
        octant = (
            (dx > 0).astype(jnp.int32)
            + 2 * (dy > 0).astype(jnp.int32)
            + 4 * (dz > 0).astype(jnp.int32)
        )
        cx = jnp.clip(((ox - lo[0]) * cell_scale[0]).astype(jnp.int32), 0, cells - 1)
        cy = jnp.clip(((oy - lo[1]) * cell_scale[1]).astype(jnp.int32), 0, cells - 1)
        cz = jnp.clip(((oz - lo[2]) * cell_scale[2]).astype(jnp.int32), 0, cells - 1)
        # cells=4 (default): key ≤ 519, 10 bits. Finer grids (cells=8 → 13
        # bits) are a config knob for the fused path; the packed
        # single-array sort below is only valid for ≤10-bit keys.
        key9 = octant + 8 * (cx + cells * cy + cells * cells * cz)
        dead_key = 8 * cells * cells * cells  # > any live key
        key9 = jnp.where(alive, key9, jnp.int32(dead_key))  # dead lanes last
        if getattr(config, "mesh_sort_fused", False):
            # one fused stable sort carrying all 14 payload operands: the
            # sort moves payloads with the keys instead of an argsort +
            # [N, 14] row gather. Stable + same key ⇒ identical
            # permutation to the argsort path; ints ride natively (no f32
            # round-trip, so no 2^24 pixel-id ceiling on this path).
            ops_ = [key9, ox, oy, oz, dx, dy, dz, cr, cg, cb, bounces,
                    rr_, rg_, rb_]
            if use_nee:
                ops_.append(prev)
            ops_.append(pixel)
            out = jax.lax.sort(tuple(ops_), num_keys=1, is_stable=True)
            return tuple(out[1:-1]), out[-1]
        if n < (1 << 21) and dead_key < (1 << 10):
            # single-array sort of (key << 21 | lane): half the sorted bytes
            # of argsort's (key, iota) pair sort. Max value 1023<<21 | (2^21-1)
            # = int32 max, so the packed key never wraps negative (needs the
            # ≤10-bit key of the default cells=4 grid).
            packed_key = (key9 << 21) | jnp.arange(n, dtype=jnp.int32)
            perm = jnp.sort(packed_key) & jnp.int32((1 << 21) - 1)
        else:
            perm = jnp.argsort(key9)
        # one row-gather for the whole wavefront instead of 14 [N] gathers
        cols_in = [ox, oy, oz, dx, dy, dz, cr, cg, cb,
                   bounces.astype(jnp.float32), rr_, rg_, rb_]
        if use_nee:
            cols_in.append(prev)
        cols_in.append(pixel.astype(jnp.float32))
        packed = jnp.stack(cols_in, axis=-1)
        packed = jnp.take(packed, perm, axis=0)
        cols = [packed[:, i] for i in range(len(cols_in))]
        carry = (tuple(cols[:9]) + (cols[9].astype(jnp.int32),)
                 + tuple(cols[10:-1]))
        return carry, cols[-1].astype(jnp.int32)

    def intersect_combined(ox, oy, oz, dx, dy, dz, alive) -> _Best:
        t, ti, nx, ny, nz, mat_f = tri_isect.call_soa(
            ox, oy, oz, dx, dy, dz, active=alive
        )
        tri_hit = ti >= 0
        best = _Best(
            t=jnp.where(tri_hit, t, _MISS),
            nx=nx, ny=ny, nz=nz,
            mat=mat_f.astype(jnp.int32),
            miss=~tri_hit,
            outside=jnp.ones_like(tri_hit),  # triangles are thin surfaces
            # NEE MIS: triangles are never in the analytic light sampler,
            # so any id it does not cover works — use -1 (pdf 0, weight 1)
            geom=jnp.full_like(ti, -1) if use_nee else None,
        )
        if has_analytic:
            a = intersect_unrolled(scene, ox, oy, oz, dx, dy, dz)
            a_wins = a.t < best.t
            best = _Best(
                t=jnp.where(a_wins, a.t, best.t),
                nx=jnp.where(a_wins, a.nx, best.nx),
                ny=jnp.where(a_wins, a.ny, best.ny),
                nz=jnp.where(a_wins, a.nz, best.nz),
                mat=jnp.where(a_wins, a.mat, best.mat),
                miss=best.miss & ~a_wins,
                outside=jnp.where(a_wins, a.outside, best.outside),
                geom=(jnp.where(a_wins, a.geom, best.geom)
                      if use_nee else None),
            )
        return best

    def bounce_at(carry, pixel, depth, sort: bool, ld_depth: int = -1):
        if sort:
            carry, pixel = sort_rays(carry, pixel)
        (ox, oy, oz, dx, dy, dz, _cr, _cg, _cb, bounces, *_rest) = carry
        # Pixel-keyed hash uniforms: the RNG stream follows the PIXEL id
        # through any reorder (the project's pixel-keyed-RNG invariant), and
        # costs no gather (threefry draws would need a [lanes, n] take). The LD lattice (sampler='sobol', leading ld_depths
        # bounces; ld_depth ≥ 0 selects its static per-depth tags) is
        # pixel-keyed the same way, so the invariant holds under it too.
        if ld_depth >= 0:
            u = rng_ops.ld_bounce_uniforms(base_key, iteration, pixel, ld_depth)
        else:
            u = rng_ops.hash_bounce_uniforms(base_key, iteration, depth, pixel)
        # Dead-lane culling changes what dead lanes "see" (miss instead of a
        # stale hit) — irrelevant in light_only (dead lanes accumulate
        # nothing) but it would re-trigger legacy's sky re-multiplication,
        # so legacy mode keeps every lane active (and skips the sort, whose
        # image-invariance also relies on the light_only estimator).
        alive = (bounces > 0) if not legacy else jnp.ones((n,), bool)
        best = intersect_combined(ox, oy, oz, dx, dy, dz, alive)
        nee = None
        if use_nee:
            def shadow_t(sx, sy, sz, wx, wy, wz):
                # distance-only query: no winner payload gathers; dead
                # lanes are not traced
                st = tri_isect.call_t(
                    sx, sy, sz, wx, wy, wz, active=alive
                )
                if has_analytic:
                    st = jnp.minimum(
                        st,
                        intersect_unrolled(scene, sx, sy, sz,
                                           wx, wy, wz).t,
                    )
                return st

            nee = (
                light_sampler,
                shadow_t,
                # PIXEL-keyed like the bounce uniforms: the per-bounce
                # resort must stay image-invariant with NEE on
                rng_ops.ld_nee_bounce_uniforms(base_key, iteration, pixel,
                                               ld_depth)
                if ld_depth >= 0
                else rng_ops.hash_nee_uniforms(base_key, iteration, depth,
                                               pixel),
            )
        return shade_soa(
            carry, best, u, scene.materials, depth, config, nee=nee
        ), pixel

    # Primary rays are coherent by construction (block order, or scanline
    # order otherwise): bounce 0 skips the sort (one argsort + one [N, 14]
    # row gather saved per sample). With sampler='sobol' the leading
    # ld_depths bounces are unrolled here (their lattice tags are static);
    # LD bounces past 0 sort like any other secondary bounce.
    n_ld = (
        min(getattr(config, "ld_depths", 1), config.trace_depth)
        if use_ld
        else 1
    )
    carry, pixel = bounce_at(carry, pixel, jnp.int32(0), sort=False,
                             ld_depth=0 if use_ld else -1)
    for d in range(1, n_ld):
        carry, pixel = bounce_at(carry, pixel, jnp.int32(d), sort=do_sort,
                                 ld_depth=d)

    # Sort cadence: a bounce leaves origins inside the tile's previous hit
    # region (spatially coherent) — only the direction octants scramble — so
    # sorting every `mesh_sort_every` bounces trades some tile coherence for
    # one argsort + [N, 14] gather per skipped bounce. The scan body covers
    # `se` bounces (first sorted); a shorter tail group is unrolled.
    se = max(1, int(getattr(config, "mesh_sort_every", 1)))

    def group(state, d0):
        carry, pixel = state
        for k in range(se):
            carry, pixel = bounce_at(
                carry, pixel, d0 + k, sort=do_sort and k == 0
            )
        return (carry, pixel), None

    rem = config.trace_depth - n_ld
    if rem > 0:
        full = rem // se
        if full:
            (carry, pixel), _ = jax.lax.scan(
                group,
                (carry, pixel),
                n_ld + se * jnp.arange(full, dtype=jnp.int32),
            )
        for k in range(rem - full * se):
            carry, pixel = bounce_at(
                carry, pixel, jnp.int32(n_ld + full * se + k),
                sort=do_sort and k == 0,
            )
    (_, _, _, _, _, _, cr, cg, cb, _, rr_, rg_, rb_) = carry[:13]
    if legacy:
        return jnp.stack([cr, cg, cb], axis=-1)
    if do_sort:
        # finalGather: radiance back to pixel order. `pixel` is a
        # permutation, so the scatter-add is an inverse-permutation gather.
        if getattr(config, "mesh_sort_fused", False):
            # fused variant: sort by pixel id with RGB as payloads — the
            # sort network does the unsort without the argsort + [N, 3]
            # row gather. Keys are a permutation (all distinct), so the
            # result is exactly pixel order; stability is irrelevant.
            _, rr_, rg_, rb_ = jax.lax.sort(
                (pixel, rr_, rg_, rb_), num_keys=1
            )
            return jnp.stack([rr_, rg_, rb_], axis=-1)
        values = jnp.stack([rr_, rg_, rb_], axis=-1)
        return jnp.take(values, jnp.argsort(pixel), axis=0)
    return jnp.stack([rr_, rg_, rb_], axis=-1)
