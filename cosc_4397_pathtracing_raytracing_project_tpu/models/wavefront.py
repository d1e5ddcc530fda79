"""Wavefront pipeline with stream compaction and material sorting.

The reference *attempted* both and shipped neither: its `dev_numActiveRays`
compaction buffer is allocated and freed unused (`pathtrace.cu:556-559,605`),
and its material sort "produced broken renders" and was removed
(`README.md:61-66`, `img/broken.png`). This module is that experiment done
correctly, in the reference's own architecture: paths carry an explicit
``pixel_index`` (PathSegment.pixelIndex, `sceneStructs.h:70`) and the final
gather is a scatter-add (`finalGather`, `pathtrace.cu:439-444`), so the path
array can be *reordered freely between bounces*:

- ``sort_alive``: partition live paths to the front each bounce (what thrust
  stream compaction would do, with static shapes via a full sort);
- ``sort_material``: group paths by hit material id (the reference's broken
  experiment — correct here because pixel identity travels with the path).

Under XLA every lane of a whole-array op is computed whether its path is
alive or not, so sorting buys locality only, not occupancy (what the
reference's warp-level compaction was after). The options exist for parity
and for benchmarking that claim; `none` is the default.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops import camera as camera_ops
from ..ops import rng as rng_ops
from ..ops.intersect import intersect_scene
from ..ops.shade import PathState, shade_step
from ..scene.structs import Scene


def trace_sample_wavefront(
    scene: Scene,
    config,
    base_key,
    iteration,
    compaction: str = "none",
    intersector=None,
) -> jnp.ndarray:
    """One sample per pixel with optional per-bounce path reordering.
    Returns the [N, 3] image contribution (pixel order)."""
    if compaction not in ("none", "sort_alive", "sort_material"):
        raise ValueError(f"unknown compaction mode {compaction!r}")
    isect = intersector if intersector is not None else intersect_scene
    cam = scene.camera
    n = cam.pixel_count

    # sampler='sobol': pixel-keyed LD draws on the first-vertex dimensions.
    # LD uniforms ride the same pixel_index gather as the threefry rows, so
    # compaction reorders stay image-invariant under either sampler.
    use_ld = getattr(config, "sampler", "independent") == "sobol"
    pix_ids = jnp.arange(n, dtype=jnp.int32)
    jitter = lens = None
    if config.antialias:
        jitter = (
            rng_ops.ld_pixel_jitter(base_key, iteration, pix_ids)
            if use_ld
            else rng_ops.pixel_jitter(base_key, iteration, n)
        )
    if getattr(config, "dof", False):
        lens = (
            rng_ops.ld_lens_uniforms(base_key, iteration, pix_ids)
            if use_ld
            else rng_ops.lens_uniforms(base_key, iteration, n)
        )
    origins, directions = camera_ops.generate_rays(cam, jitter, lens=lens)
    paths = PathState(
        origin=origins,
        direction=directions,
        color=jnp.ones((n, 3), jnp.float32),
        bounces=jnp.full((n,), config.trace_depth, jnp.int32),
    )
    pixel_index = jnp.arange(n, dtype=jnp.int32)
    radiance = jnp.zeros((n, 3), jnp.float32)

    def permute(paths, pixel_index, radiance, perm):
        take = lambda x: jnp.take(x, perm, axis=0)
        return (
            jax.tree.map(take, paths),
            jnp.take(pixel_index, perm),
            jnp.take(radiance, perm, axis=0),
        )

    def bounce(carry, depth, u_all=None):
        paths, pixel_index, radiance = carry
        uniforms_all = (
            u_all
            if u_all is not None
            else rng_ops.bounce_uniforms(base_key, iteration, depth, n)
        )
        # RNG is keyed by *pixel*, not lane, so reordering does not change
        # which numbers a path sees (replayability under compaction — this is
        # what the reference's broken material sort got wrong by reseeding
        # per lane index after the sort).
        uniforms = jnp.take(uniforms_all, pixel_index, axis=0)
        hit = isect(scene, paths.origin, paths.direction)
        paths, contrib = shade_step(
            paths,
            hit,
            scene.materials,
            uniforms,
            depth,
            config.rr_start_depth,
            gather_mode=config.gather_mode,
            sky_strength=config.sky_strength,
            env=scene.envmap,
        )
        radiance = radiance + contrib
        if compaction == "sort_alive":
            perm = jnp.argsort(~paths.alive, stable=True)
            paths, pixel_index, radiance = permute(
                paths, pixel_index, radiance, perm
            )
        elif compaction == "sort_material":
            key_mat = jnp.where(paths.alive, hit.material_id, jnp.int32(2**20))
            perm = jnp.argsort(key_mat, stable=True)
            paths, pixel_index, radiance = permute(
                paths, pixel_index, radiance, perm
            )
        return (paths, pixel_index, radiance), None

    carry0 = (paths, pixel_index, radiance)
    start = 0
    if use_ld:
        # LD bounces unrolled: rows are built in pixel order and ride the
        # same pixel_index gather as the threefry rows, so the per-depth
        # lattice stays image-invariant under compaction reorders
        for d in range(min(getattr(config, "ld_depths", 1),
                           config.trace_depth)):
            carry0, _ = bounce(
                carry0,
                jnp.int32(d),
                u_all=rng_ops.ld_bounce_uniforms(
                    base_key, iteration, pix_ids, d
                ).T,
            )
            start = d + 1
    (paths, pixel_index, radiance), _ = jax.lax.scan(
        bounce,
        carry0,
        jnp.arange(start, config.trace_depth, dtype=jnp.int32),
    )

    values = paths.color if config.gather_mode == "throughput" else radiance
    # finalGather: scatter path values back to pixel order
    out = jnp.zeros((n, 3), jnp.float32)
    return out.at[pixel_index].add(values)


def render_chunk_wavefront(
    scene: Scene,
    state,
    config,
    num_samples: int,
    compaction: str = "none",
    intersector=None,
):
    def body(accum, i):
        iteration = state.iteration + 1 + i
        color = trace_sample_wavefront(
            scene, config, state.key, iteration, compaction, intersector
        )
        return accum + color, None

    accum, _ = jax.lax.scan(
        body, state.accum, jnp.arange(num_samples, dtype=jnp.int32)
    )
    return state.replace(
        accum=accum, iteration=state.iteration + jnp.int32(num_samples)
    )
