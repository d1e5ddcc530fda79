"""The per-bounce shade/extend stage (`shadeAndExtendRays`,
`src/pathtrace.cu:336-437`), as a pure masked-wavefront function.

Where the reference early-returns per thread, this computes every branch for
every lane and blends with ``where`` masks — the XLA-native replacement for
SIMT divergence. The reference's quirks are preserved deliberately for
image-level parity:

- the sky factor is applied on *every* depth at which the stored ray misses,
  including lanes already terminated by an earlier miss (the reference's
  early-out only checks ``hit.t < 0``, `pathtrace.cu:356-365`, and dead lanes
  keep re-intersecting their stale ray each depth);
- Russian roulette starts strictly after depth 3 (`pathtrace.cu:381-388`);
- the RNG is consumed in the same *roles* (not the same bit-stream):
  roulette, branch select, two-to-three direction samples;
- ``hasRefractive`` is (mis)used as ``1 - roughness`` for the glossy cone
  (`pathtrace.cu:400`), and the branch tint is the specular color for the
  mirror path and the albedo for the diffuse path.

The reference loads the material table into CUDA shared memory
(`pathtrace.cu:343-350`); here the table is gathered per-lane with a one-hot
contraction over the few-row table, which XLA fuses into the shading
kernel as constants — the analog of that cache.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import PyTreeNode

from ..scene.structs import Materials
from . import linalg, rng, sampling
from .intersect import Hit, take_rows

_ORIGIN_OFFSET = 1e-3  # self-intersection offset (`pathtrace.cu:418,431`)


class PathState(PyTreeNode):
    """SoA PathSegment (`sceneStructs.h:67-72`)."""

    origin: jnp.ndarray  # (N, 3) f32
    direction: jnp.ndarray  # (N, 3) f32
    color: jnp.ndarray  # (N, 3) f32 throughput
    bounces: jnp.ndarray  # (N,) i32 remaining bounces

    @property
    def alive(self) -> jnp.ndarray:
        return self.bounces > 0


def init_paths(origins, directions, trace_depth: int) -> PathState:
    n = origins.shape[0]
    return PathState(
        origin=origins,
        direction=directions,
        color=jnp.ones((n, 3), jnp.float32),
        bounces=jnp.full((n,), trace_depth, jnp.int32),
    )


def _gather_materials(
    materials: Materials, material_id: jnp.ndarray, with_ior: bool = False
):
    """Per-lane material fetch: pack the table to [M, 9|10] and one-hot-matmul.

    Layout: color(3) | specular_color(3) | reflectivity | refractive |
    emittance | [ior]."""
    cols = [
        materials.color,
        materials.specular_color,
        materials.reflectivity[:, None],
        materials.refractive[:, None],
        materials.emittance[:, None],
    ]
    if with_ior:
        cols.append(materials.ior[:, None])
    packed = jnp.concatenate(cols, axis=1)
    rows = take_rows(packed, material_id)
    out = {
        "color": rows[:, 0:3],
        "specular_color": rows[:, 3:6],
        "reflectivity": rows[:, 6],
        "refractive": rows[:, 7],
        "emittance": rows[:, 8],
    }
    if with_ior:
        out["ior"] = rows[:, 9]
    return out


def shade_step(
    paths: PathState,
    hit: Hit,
    materials: Materials,
    uniforms: jnp.ndarray,
    depth,
    rr_start_depth: int = 3,
    gather_mode: str = "throughput",
    sky_strength: float = 1.0,
    enable_refraction: bool = False,
    nee=None,
    prev_pdf: jnp.ndarray = None,
    env=None,
    env_nee=None,
):
    """One masked shade/extend pass. Returns ``(new_paths, radiance_contrib)``
    — or, when ``nee`` (an :class:`~..ops.lights.NEEInputs`) is given,
    ``(new_paths, radiance_contrib, prev_pdf_next)``: direct light is sampled
    at every diffuse-capable vertex and combined with BRDF sampling by the
    balance heuristic (see ops/lights.py). ``prev_pdf`` carries the solid-
    angle density with which the previous vertex's diffuse lobe generated
    this ray (−1 for primary/specular/glass rays, which keep MIS weight 1).

    ``uniforms`` is [N, rng.NUM_LANES]; ``depth`` is the 0-based bounce
    counter (scalar, may be traced).

    ``env`` (an :class:`~..ops.envmap.EnvMap`) swaps the gradient sky for
    an HDR environment lookup; ``env_nee`` (an
    :class:`~..ops.envmap.EnvNEEInputs`) additionally importance-samples
    the environment at every diffuse-capable vertex with its own MIS pair
    against BRDF sampling (returns the 3-tuple form, like ``nee``).

    gather_mode selects the estimator:

    - ``"throughput"`` — faithful to the reference *code*: every path's final
      throughput product is added to the image by finalGather
      (`pathtrace.cu:439-444`), misses multiply the sky factor in on every
      depth, and RR-killed / depth-exhausted paths still contribute their
      products. ``radiance_contrib`` is all zeros; the caller adds the final
      ``paths.color`` after the bounce loop.
    - ``"light_only"`` — the physically-correct estimator of the upstream
      CIS565 reference render (`img/REFERENCE_cornell.5000samp.png`): a path
      contributes ``throughput × emittance × color`` when it hits an emissive
      surface, ``throughput × sky × sky_strength`` once when it escapes
      (``sky_strength = 0`` reproduces the golden image's black background),
      and nothing when RR-killed or depth-exhausted. RR keeps its 1/p
      compensation, making the estimate unbiased.
    """
    u_rr = uniforms[:, rng.U_RR]
    u_branch = uniforms[:, rng.U_BRANCH]
    u_a = uniforms[:, rng.U_A]
    u_b = uniforms[:, rng.U_B]
    u_c = uniforms[:, rng.U_C]

    if gather_mode not in ("throughput", "light_only"):
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    legacy = gather_mode == "throughput"
    if (nee is not None or env_nee is not None) and legacy:
        raise ValueError("nee requires gather_mode='light_only'")
    carry_pdf = nee is not None or env_nee is not None

    alive = paths.alive
    missed = hit.miss
    contrib = jnp.zeros_like(paths.color)

    # ── miss / dead early-out (`pathtrace.cu:356-365`) ──
    # Extension: an ENVIRONMENT-block scene replaces the reference's
    # hard-coded gradient with an HDR map lookup (ops/envmap.py); the
    # estimator structure is unchanged.
    if env is not None:
        from . import envmap as envmap_ops

        sky = envmap_ops.env_radiance(env, paths.direction)
    else:
        sky = sampling.sky_color(paths.direction)
    if legacy:
        # Sky multiplies on every miss, even for already-dead lanes (see
        # module docstring); termination zeroes the bounce counter.
        color = jnp.where(missed[:, None], paths.color * sky, paths.color)
    else:
        # Correct estimator: an escaping path contributes the environment
        # radiance once (only while alive) and is done.
        color = paths.color
        if env is not None:
            esc = color * sky
            if env_nee is not None:
                # MIS partner of env importance sampling: a BRDF-sampled
                # escape competes with the env sampler having produced the
                # same direction (both densities in solid angle); primary/
                # specular/glass rays (prev_pdf < 0) keep weight 1.
                from . import envmap as envmap_ops

                p_env = envmap_ops.env_pdf(env, paths.direction)
                w_esc = jnp.where(
                    prev_pdf < 0.0,
                    1.0,
                    prev_pdf / jnp.maximum(prev_pdf + p_env, 1e-20),
                )
                esc = esc * w_esc[:, None]
            contrib = jnp.where((missed & alive)[:, None], esc, contrib)
        elif sky_strength:
            contrib = jnp.where(
                (missed & alive)[:, None],
                color * sky * jnp.float32(sky_strength),
                contrib,
            )
    early_out = missed | ~alive
    act = ~early_out

    mat = _gather_materials(materials, hit.material_id, enable_refraction)

    # ── emissive termination (`pathtrace.cu:374-378`) ──
    emissive = mat["emittance"] > 0.0
    hit_light = act & emissive
    light_radiance = color * mat["color"] * mat["emittance"][:, None]
    if nee is not None:
        # MIS (balance heuristic): a BRDF-sampled emissive hit reached via
        # the previous vertex's *diffuse* lobe competes with NEE having
        # sampled the same point — weight by its share of the combined
        # density (both converted to solid angle at the previous vertex).
        # Primary/specular/glass rays (prev_pdf < 0) and points the sampler
        # can't produce keep weight 1.
        p_nee_area, sampled = nee.sampler.area_pdf_at(
            hit.geom_index, hit.normal
        )
        cos_l = jnp.maximum(-linalg.dot(paths.direction, hit.normal), 1e-6)
        p_nee_dir = p_nee_area * hit.t * hit.t / cos_l
        w_emit = jnp.where(
            (prev_pdf < 0.0) | ~sampled,
            1.0,
            prev_pdf / jnp.maximum(prev_pdf + p_nee_dir, 1e-20),
        )
        light_radiance = light_radiance * w_emit[:, None]
    if legacy:
        color = jnp.where(hit_light[:, None], light_radiance, color)
    else:
        contrib = jnp.where(hit_light[:, None], light_radiance, contrib)
    act = act & ~emissive

    # ── Russian roulette after rr_start_depth (`pathtrace.cu:381-388`) ──
    rr_on = jnp.asarray(depth, jnp.int32) > rr_start_depth
    p_continue = jnp.max(mat["color"], axis=-1)
    rr_kill = act & rr_on & (u_rr > p_continue)
    rr_survive = act & rr_on & ~rr_kill
    color = jnp.where(
        rr_survive[:, None], color / jnp.maximum(p_continue, 1e-12)[:, None], color
    )
    act = act & ~rr_kill

    # ── scatter (`pathtrace.cu:394-436`) ──
    reflectivity = mat["reflectivity"]
    roughness = 1.0 - mat["refractive"]
    spec = act & (reflectivity > 0.0) & (u_branch < reflectivity)
    glass_mask = jnp.zeros_like(act)

    spec_dir = sampling.perturbed_specular(
        paths.direction, hit.normal, roughness, u_a, u_c
    )
    diff_dir = sampling.cosine_weighted_hemisphere(u_a, u_b, hit.normal)
    new_dir = jnp.where(spec[:, None], spec_dir, diff_dir)
    tint = jnp.where(spec[:, None], mat["specular_color"], mat["color"])
    new_origin = hit.point + hit.normal * _ORIGIN_OFFSET

    if enable_refraction:
        # Extension: dielectric transmission via Snell + Schlick Fresnel.
        # The reference parses REFRIOR (`scene.cpp:179-180`) and defines
        # schlickFresnel (`pathtrace.cu:244-248`) but never refracts; this
        # is gated off by default to preserve parity. A material refracts
        # when ior > 0 and hasRefractive > 0 (hasRefractive keeps its
        # roughness meaning for ior == 0 materials).
        is_glass = (mat["ior"] > 0.0) & (mat["refractive"] > 0.0)
        n = hit.normal  # already faces the incoming ray
        cos_i = jnp.clip(-linalg.dot(paths.direction, n), 0.0, 1.0)
        n1 = jnp.where(hit.outside, 1.0, mat["ior"])
        n2 = jnp.where(hit.outside, mat["ior"], 1.0)
        eta = n1 / jnp.maximum(n2, 1e-6)
        sin2_t = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
        tir = sin2_t > 1.0
        cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
        fresnel = sampling.schlick_fresnel(cos_i, n1, n2)
        refract_dir = linalg.normalize(
            eta[:, None] * paths.direction
            + (eta * cos_i - cos_t)[:, None] * n,
            eps=1e-20,
        )
        reflect_dir = linalg.reflect(paths.direction, n)
        transmit = is_glass & ~tir & (u_branch >= fresnel)
        glass_dir = jnp.where(transmit[:, None], refract_dir, reflect_dir)
        glass_origin = jnp.where(
            transmit[:, None],
            hit.point - n * _ORIGIN_OFFSET,  # step through the interface
            hit.point + n * _ORIGIN_OFFSET,
        )
        glass_mask = act & is_glass
        new_dir = jnp.where(glass_mask[:, None], glass_dir, new_dir)
        new_origin = jnp.where(glass_mask[:, None], glass_origin, new_origin)
        tint = jnp.where(
            glass_mask[:, None],
            jnp.where(
                transmit[:, None], mat["color"], mat["specular_color"]
            ),
            tint,
        )

    if nee is not None:
        # ── direct light at this vertex (extension; ops/lights.py) ──
        # Estimates the diffuse component of the mixture BRDF,
        # (1−P_spec)·albedo/π, for every diffuse-capable lane regardless of
        # which lobe the extension ray sampled; `color` here is the post-RR,
        # pre-tint throughput — exactly T at this vertex. The balance-
        # heuristic partner term lives at the emissive-hit branch above.
        inv_pi = jnp.float32(0.3183098861837907)
        base = act & ~glass_mask
        sx = hit.point + hit.normal * _ORIGIN_OFFSET
        lp, ln, pdf_a, le = nee.sampler.sample(nee.uniforms)
        to_l = lp - sx
        dist = linalg.norm(to_l)
        wi = to_l / jnp.maximum(dist, 1e-12)[:, None]
        cos_s = linalg.dot(hit.normal, wi)
        cos_l = linalg.dot(ln, -wi)
        facing = (cos_s > 0.0) & (cos_l > 0.0) & (dist > 1e-4)
        sh = nee.shadow_isect(sx, wi)
        # the sampled point itself intersects at ~dist (minus the
        # intersector backoff); anything nearer occludes
        visible = sh.t >= dist - jnp.maximum(1e-3, 1e-3 * dist)
        diffuse_prob = 1.0 - reflectivity
        w_diff = diffuse_prob[:, None] * mat["color"] * inv_pi
        # balance heuristic vs the diffuse lobe's chance of hitting the
        # same point by itself (both densities in area measure at the light)
        p_brdf_area = (
            diffuse_prob
            * jnp.maximum(cos_s, 0.0)
            * inv_pi
            * jnp.maximum(cos_l, 0.0)
            / jnp.maximum(dist * dist, 1e-12)
        )
        w_mis = pdf_a / jnp.maximum(pdf_a + p_brdf_area, 1e-20)
        geom = cos_s * cos_l / jnp.maximum(dist * dist * pdf_a, 1e-20)
        direct = color * w_diff * (geom * w_mis)[:, None] * le
        contrib = jnp.where(
            (base & facing & visible)[:, None], contrib + direct, contrib
        )

    if env_nee is not None:
        # ── direct environment light at this vertex (extension;
        # ops/envmap.py) — same estimator shape as the area-light NEE
        # above, with the light pdf in SOLID-ANGLE measure (no distance
        # geometry term) and visibility = "the shadow ray escapes the
        # scene entirely". The two NEE techniques cover disjoint radiance
        # sources (emissive surfaces vs the infinite environment), so each
        # forms its own MIS pair with BRDF sampling.
        from . import envmap as envmap_ops

        inv_pi = jnp.float32(0.3183098861837907)
        base = act & ~glass_mask
        sx = hit.point + hit.normal * _ORIGIN_OFFSET
        wi, _le_nearest, pdf_e = envmap_ops.sample_env(
            env_nee.env, env_nee.uniforms[:, 0], env_nee.uniforms[:, 1]
        )
        # BOTH techniques must integrate the same L: use the same bilinear
        # lookup as the miss path (mixing nearest-texel radiance here with
        # bilinear there would make the MIS weights sum to 1 against two
        # different integrands — biased wherever they disagree)
        le = envmap_ops.env_radiance(env_nee.env, wi)
        cos_s = linalg.dot(hit.normal, wi)
        sh = env_nee.shadow_isect(sx, wi)
        visible = sh.miss
        diffuse_prob = 1.0 - reflectivity
        w_diff = diffuse_prob[:, None] * mat["color"] * inv_pi
        p_brdf = diffuse_prob * jnp.maximum(cos_s, 0.0) * inv_pi
        w_mis = pdf_e / jnp.maximum(pdf_e + p_brdf, 1e-20)
        direct = color * w_diff * (
            jnp.maximum(cos_s, 0.0) / jnp.maximum(pdf_e, 1e-20) * w_mis
        )[:, None] * le
        contrib = jnp.where(
            (base & (cos_s > 0.0) & visible)[:, None], contrib + direct, contrib
        )

    color = jnp.where(act[:, None], color * tint, color)
    origin = jnp.where(act[:, None], new_origin, paths.origin)
    direction = jnp.where(act[:, None], new_dir, paths.direction)
    bounces = jnp.where(act, paths.bounces - 1, jnp.zeros_like(paths.bounces))

    new_paths = PathState(
        origin=origin, direction=direction, color=color, bounces=bounces
    )
    if carry_pdf:
        # Density with which THIS vertex's lobe choice generated the
        # extension ray: diffuse lanes carry (1−P)·cosθ/π for the next
        # emissive hit's MIS weight; specular/glass lobes are treated as
        # delta (weight 1 → marker −1). Dead lanes never pass `act` again.
        cos_new = jnp.maximum(linalg.dot(new_dir, hit.normal), 0.0)
        inv_pi = jnp.float32(0.3183098861837907)
        diffuse_ext = act & ~spec & ~glass_mask
        pdf_next = jnp.where(
            diffuse_ext,
            (1.0 - reflectivity) * cos_new * inv_pi,
            jnp.float32(-1.0),
        )
        return new_paths, contrib, pdf_next
    return new_paths, contrib
