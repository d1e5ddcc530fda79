"""Multi-chip render step: shard_map over the ('sp', 'dp') mesh.

Each dp rank traces a contiguous tile of the flat pixel array; each sp rank
traces a disjoint subset of the sample iterations for those pixels, and the
per-chunk partial accumulators are combined with one ``psum`` over the
sample axis (the only collective — paths are independent, so there is no
halo traffic). Scene pytrees are replicated (they are KBs); the accumulator
lives sharded over dp for its whole life, so no full-frame gather happens
until the host asks for pixels.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..render.engine import RenderConfig, trace_sample
from ..render.state import RenderState
from ..scene.structs import Scene
from .mesh import PIXEL_AXIS, SAMPLE_AXIS


def _resolve_dof(scene: Scene, config: RenderConfig) -> RenderConfig:
    """Resolve config.dof=None (auto) to a concrete static bool while the
    scene is concrete — the same rule Renderer.__init__ applies (on iff the
    camera's aperture > 0). Inside shard_map the camera is a tracer, so
    the gate must be fixed here."""
    if getattr(config, "dof", None) is None:
        import dataclasses

        config = dataclasses.replace(
            config, dof=bool(float(scene.camera.aperture) > 0.0)
        )
    return config


def _shard_extents(scene: Scene, num_samples: int, mesh: Mesh):
    """(local_pixels, local_samples) after validating divisibility."""
    n_total = scene.camera.pixel_count
    n_dp = mesh.shape[PIXEL_AXIS]
    n_sp = mesh.shape[SAMPLE_AXIS]
    if n_total % n_dp != 0:
        raise ValueError(f"pixel count {n_total} not divisible by dp={n_dp}")
    if num_samples % n_sp != 0:
        raise ValueError(f"num_samples {num_samples} not divisible by sp={n_sp}")
    return n_total // n_dp, num_samples // n_sp


def _run_sharded(body, scene: Scene, state: RenderState, mesh: Mesh,
                 num_samples: int) -> RenderState:
    """Common shard_map wiring: `body(scene, accum_local, iteration, key)`
    returns the rank's updated local accumulator. Inputs are placed on the
    mesh (scene/state may arrive committed to a single device): scene
    replicated, accumulator sharded over dp."""
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(PIXEL_AXIS, None), P(), P()),
        out_specs=P(PIXEL_AXIS, None),
        # The bounce-scan carry starts replicated (raygen) and becomes
        # device-varying once per-tile RNG enters; skip the VMA check rather
        # than pvary-annotating every carry leaf.
        check_vma=False,
    )
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    accum_in = jax.device_put(state.accum, NamedSharding(mesh, P(PIXEL_AXIS, None)))
    iteration = jax.device_put(state.iteration, NamedSharding(mesh, P()))
    key = jax.device_put(state.key, NamedSharding(mesh, P()))
    accum = sharded(scene, accum_in, iteration, key)
    return state.replace(
        accum=accum, iteration=state.iteration + jnp.int32(num_samples)
    )


def render_chunk_sharded(
    scene: Scene,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    mesh: Mesh,
    intersector: Optional[Callable] = None,
    light_sampler=None,
) -> RenderState:
    """Accumulate `num_samples` samples, sharded over the mesh. Both
    `num_samples` and the mesh are static; `num_samples` must divide by the
    sp extent and the pixel count by the dp extent."""
    local_pixels, local_samples = _shard_extents(scene, num_samples, mesh)

    def body(scene, accum_local, iteration, key):
        dp = jax.lax.axis_index(PIXEL_AXIS)
        sp = jax.lax.axis_index(SAMPLE_AXIS)
        offset = dp * local_pixels
        tile_key = jax.random.fold_in(key, dp)

        def one(acc, i):
            it = iteration + 1 + sp * jnp.int32(local_samples) + i
            color = trace_sample(
                scene,
                config,
                tile_key,
                it,
                intersector,
                pixel_offset=offset,
                num_pixels=local_pixels,
                light_sampler=light_sampler,
            )
            return acc + color, None

        partial_accum, _ = jax.lax.scan(
            one,
            jnp.zeros((local_pixels, 3), jnp.float32),
            jnp.arange(local_samples, dtype=jnp.int32),
        )
        partial_accum = jax.lax.psum(partial_accum, SAMPLE_AXIS)
        return accum_local + partial_accum

    return _run_sharded(body, scene, state, mesh, num_samples)


def render_chunk_sharded_mesh(
    scene: Scene,
    state: RenderState,
    config: RenderConfig,
    num_samples: int,
    mesh: Mesh,
    tri_isect,
    light_sampler=None,
) -> RenderState:
    """Multi-device triangle-mesh step: each dp rank runs the sorted-
    wavefront mesh pipeline (ops.fast.trace_sample_mesh + the BVH triangle
    intersector) on its contiguous pixel slice; sp ranks split samples and
    combine with one psum. The BVH tables are replicated (a few MB).
    RNG (bounce uniforms AND antialias jitter) keys on the *global* pixel
    id, so every shard traces exactly the paths the single-device render
    would; per-pixel results match to float reassociation (1-2 ulp — XLA
    fuses the differently-shaped per-shard graphs differently)."""
    from ..ops import fast

    local_pixels, local_samples = _shard_extents(scene, num_samples, mesh)

    def body(scene, accum_local, iteration, key):
        dp = jax.lax.axis_index(PIXEL_AXIS)
        sp = jax.lax.axis_index(SAMPLE_AXIS)
        offset = dp * jnp.int32(local_pixels)

        def one(acc, i):
            it = iteration + 1 + sp * jnp.int32(local_samples) + i
            color = fast.trace_sample_mesh(
                scene, config, key, it, tri_isect,
                pixel_offset=offset, num_pixels=local_pixels,
                light_sampler=light_sampler,
            )
            return acc + color, None

        rad, _ = jax.lax.scan(
            one,
            jnp.zeros((local_pixels, 3), jnp.float32),
            jnp.arange(local_samples, dtype=jnp.int32),
        )
        rad = jax.lax.psum(rad, SAMPLE_AXIS)
        return accum_local + rad

    return _run_sharded(body, scene, state, mesh, num_samples)


def make_sharded_mesh_step(
    scene: Scene,
    config: RenderConfig,
    num_samples: int,
    mesh: Mesh,
):
    """jit-compiled closure over the static pieces (mesh pipeline). The
    triangle intersector (BVH + leaf-ordered triangle tables) is built once
    here from the concrete scene and closed over — inside the trace the
    scene arrays are tracers."""
    config = _resolve_dof(scene, config)
    from ..render.engine import make_mesh_intersector

    tri_isect = make_mesh_intersector(scene, config.bvh_leaf_size)
    light_sampler = None
    if getattr(config, "nee", False):
        from ..ops.lights import make_light_sampler

        light_sampler = make_light_sampler(scene)
        if light_sampler is None:
            raise ValueError(
                "config.nee=True but the scene has no emissive analytic "
                "(cube/sphere) lights to sample"
            )
    fn = partial(
        render_chunk_sharded_mesh,
        config=config,
        num_samples=num_samples,
        mesh=mesh,
        tri_isect=tri_isect,
        light_sampler=light_sampler,
    )
    return jax.jit(lambda scene, state: fn(scene, state))


def render_tiles_sharded(
    scene: Scene,
    config: RenderConfig,
    key,
    pix,
    bases,
    num_samples: int,
    mesh: Mesh,
    light_sampler=None,
):
    """Multi-device tile-selected dispatch (the adaptive sampler's
    render.adaptive.render_tiles) sharded over the selected-tile axis.

    Tiles are fully independent work items whose identity is *data* (pixel
    ids + iteration base per row), so the M-row dispatch shards over ALL
    mesh devices at once — the leading axis splits over the flattened
    ('sp','dp') axes, each rank tracing its contiguous M/n_devices rows.
    No collective at all: the radiance comes back sharded over the same
    axis and the caller's scatter-add consumes it. Every draw is keyed by
    (pixel, iteration), so each row's result does not depend on which
    rank traces it.

    M must divide by the mesh's device count (the adaptive driver rounds
    its selection size up to guarantee this)."""
    from ..render.adaptive import render_tiles

    n_dev = mesh.devices.size
    m = pix.shape[0]
    if m % n_dev != 0:
        raise ValueError(
            f"selected tile count {m} not divisible by {n_dev} devices"
        )
    tile_axes = (SAMPLE_AXIS, PIXEL_AXIS)
    # the light sampler rides as an explicit replicated operand (absent
    # entirely without nee: an empty pytree has no spec to match)
    extra = () if light_sampler is None else (light_sampler,)

    def body(scene, key, pix, bases, *extra):
        sampler = extra[0] if extra else None
        return render_tiles(
            scene, config, key, pix, bases, num_samples, sampler
        )

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(tile_axes, None), P(tile_axes))
        + (P(),) * len(extra),
        out_specs=P(tile_axes, None, None),
        check_vma=False,
    )
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    return sharded(scene, key, pix, bases, *extra)


def make_sharded_step(
    scene: Scene,
    config: RenderConfig,
    num_samples: int,
    mesh: Mesh,
    intersector: Optional[Callable] = None,
):
    """jit-compiled closure over the static pieces (incl. the nee light
    sampler, built here while the scene is concrete)."""
    config = _resolve_dof(scene, config)
    light_sampler = None
    if getattr(config, "nee", False):
        from ..ops.lights import make_light_sampler

        light_sampler = make_light_sampler(scene)
        if light_sampler is None and scene.envmap is None:
            raise ValueError(
                "config.nee=True but the scene has no emissive analytic "
                "(cube/sphere) lights and no ENVIRONMENT map to sample"
            )
    fn = partial(
        render_chunk_sharded,
        config=config,
        num_samples=num_samples,
        mesh=mesh,
        intersector=intersector,
        light_sampler=light_sampler,
    )
    return jax.jit(lambda scene, state: fn(scene, state))
