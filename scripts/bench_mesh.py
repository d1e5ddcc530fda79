"""Mesh-pipeline microbenchmark (BASELINE config 5 scene) on the GPU.

Times warm samples of trace_sample_mesh at 1080p over the 38.5k-triangle
scene through the XLA BVH intersector (render.engine.make_mesh_intersector),
and sweeps the wavefront-sort knobs when asked.

    python scripts/bench_mesh.py [--samples 3] [--depth 8] [--res 1920x1080]
                                 [--no-sort] [--nee] [--leaf N]

With --compare it instead renders the scene through Renderer with each
pipeline ('fast_mesh', 'reference') at each BVH leaf size, every
configuration compiled first and then timed in interleaved rounds, and
prints the rays/s of every run and their median per configuration:

    python scripts/bench_mesh.py --compare [--leaves 1,2,4] [--repeats 3]
                                           [--spp 2]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
    enable_compile_cache,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--no-sort", action="store_true")
    ap.add_argument("--batch", type=int, default=1,
                    help="samples per jitted dispatch")
    ap.add_argument("--sort-every", type=int, default=1,
                    help="sort the wavefront every Nth bounce")
    ap.add_argument("--fused-sort", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused lax.sort with payloads instead of argsort+"
                         "gather (default on)")
    ap.add_argument("--sort-cells", type=int, default=2,
                    help="origin-grid resolution of the sort key "
                         "(default 2)")
    ap.add_argument("--nee", action="store_true",
                    help="direct light sampling + MIS (BVH shadow rays; "
                         "needs an analytic emitter)")
    ap.add_argument("--leaf", type=int, default=None,
                    help="BVH leaf size (default ops.bvh.LEAF_SIZE)")
    ap.add_argument("--compare", action="store_true",
                    help="time both mesh pipelines at each of --leaves")
    ap.add_argument("--leaves", default="1,2,4")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--spp", type=int, default=2,
                    help="samples per timed --compare render")
    args = ap.parse_args()
    device.require_gpu()
    enable_compile_cache()
    print(f"card: {' | '.join(device.card_lines())}", file=sys.stderr)

    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig
    from cosc_4397_pathtracing_raytracing_project_tpu.ops import fast
    from cosc_4397_pathtracing_raytracing_project_tpu.render.engine import (
        make_mesh_intersector,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.scene import (
        Scene,
        load_scene_desc,
    )

    scenes = os.path.join(os.path.dirname(__file__), "..", "scenes")
    desc = load_scene_desc(os.path.join(scenes, "mesh1080p.txt"))
    w, h = (int(v) for v in args.res.split("x"))
    desc.camera.resolution = (w, h)
    scene = Scene.from_desc(desc)
    print(f"scene: {scene.triangles.count} tris, {w}x{h}", file=sys.stderr)
    if args.compare:
        return compare(desc, args)

    from cosc_4397_pathtracing_raytracing_project_tpu.ops import bvh

    tri_isect = make_mesh_intersector(scene, args.leaf or bvh.LEAF_SIZE)
    sampler = None
    if args.nee:
        from cosc_4397_pathtracing_raytracing_project_tpu.ops.lights import (
            make_light_sampler,
        )

        sampler = make_light_sampler(scene)
        assert sampler is not None, "scene has no analytic emitter"
    cfg = RenderConfig(
        trace_depth=args.depth,
        sky_strength=1.0,
        nee=args.nee,
        mesh_ray_sort=not args.no_sort,
        mesh_sort_every=args.sort_every,
        mesh_sort_fused=args.fused_sort,
        mesh_sort_cells=args.sort_cells,
    )

    import functools

    @functools.partial(jax.jit, static_argnames=("k",))
    def run(scene, key, iteration, k):
        def body(i, acc):
            return acc + fast.trace_sample_mesh(
                scene, cfg, key, iteration + i, tri_isect,
                light_sampler=sampler,
            )
        acc0 = jnp.zeros((scene.camera.pixel_count, 3), jnp.float32)
        if k == 1:
            return acc0 + fast.trace_sample_mesh(
                scene, cfg, key, iteration, tri_isect, light_sampler=sampler
            )
        return jax.lax.fori_loop(0, k, body, acc0)

    key = jax.random.PRNGKey(0)
    t0 = time.time()
    run(scene, key, jnp.int32(1), args.batch).block_until_ready()
    print(f"compile+first: {time.time()-t0:.2f}s", file=sys.stderr)

    best = float("inf")
    for i in range(args.samples):
        t0 = time.time()
        out = run(scene, key, jnp.int32(2 + i * args.batch), args.batch)
        out.block_until_ready()
        dt = (time.time() - t0) / args.batch
        best = min(best, dt)
        print(f"sample {i}: {dt*1e3:.1f} ms/sample", file=sys.stderr)

    rays = w * h
    print(
        {
            "ms_per_sample": round(best * 1e3, 2),
            "mrays_per_sec": round(rays / best / 1e6, 3),
            "depth": args.depth,
            "sort": not args.no_sort,
            "batch": args.batch,
            "nee": args.nee,
            "device": device.device_record(),
        }
    )


def compare(desc, args):
    """Both mesh pipelines × leaf sizes through Renderer, interleaved."""
    import json
    import statistics

    from cosc_4397_pathtracing_raytracing_project_tpu import (
        RenderConfig,
        Renderer,
    )

    configs = {}
    for leaf in (int(v) for v in args.leaves.split(",")):
        for pipeline in ("fast_mesh", "reference"):
            cfg = RenderConfig(
                trace_depth=args.depth, pipeline=pipeline, nee=args.nee,
                bvh_leaf_size=leaf, samples_per_launch=args.spp,
            )
            r = Renderer(desc, cfg)
            t0 = time.perf_counter()
            r.step(args.spp)  # compile
            r.sync()
            print(f"{pipeline} leaf {leaf}: compile+first "
                  f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
            configs[(pipeline, leaf)] = r
    pixels = next(iter(configs.values())).scene.camera.pixel_count
    rates = {k: [] for k in configs}
    for rep in range(args.repeats):
        for (pipeline, leaf), r in configs.items():
            r.reset()
            t0 = time.perf_counter()
            r.render(args.spp)
            r.sync()
            rate = pixels * args.spp / (time.perf_counter() - t0)
            rates[(pipeline, leaf)].append(rate)
            print(f"run {rep} {pipeline} leaf {leaf}: {rate:.6e} rays/s",
                  file=sys.stderr)
    summary = {
        f"{p} leaf {l}": {"median_rays_per_s": statistics.median(v),
                          "runs": v}
        for (p, l), v in rates.items()
    }
    print(json.dumps({"spp": args.spp, "depth": args.depth,
                      "configs": summary, "card": device.card_lines(),
                      "device": device.device_record()}))


if __name__ == "__main__":
    main()
