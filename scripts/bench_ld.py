"""A/B the padded-Sobol depth extension (RenderConfig.ld_depths) on the GPU.

For each arm (ld_depths value): golden-image PSNR at 200 and 1000 spp on the
upstream golden Cornell (the quality axis), and a best-of-3 rays/s lap on the
headline bench configuration (the cost axis). Arms alternate their timing
laps so drift in the card's clocks hits every arm alike.

Usage: python scripts/bench_ld.py [--depths 1 2 3] [--iters 300] [--chunk 200]
"""

import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _setup():
    from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
        enable_compile_cache,
    )

    device.require_gpu()
    enable_compile_cache()
    print(f"card: {' | '.join(device.card_lines())}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--skip-quality", action="store_true")
    ap.add_argument("--skip-speed", action="store_true")
    args = ap.parse_args()
    _setup()

    import numpy as np

    from cosc_4397_pathtracing_raytracing_project_tpu import (
        RenderConfig,
        Renderer,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png

    golden_png = os.path.join(
        REPO, "tests", "data", "REFERENCE_cornell.5000samp.png"
    )
    golden_scene = os.path.join(REPO, "scenes", "cornell_golden.txt")
    cornell = os.path.join(REPO, "scenes", "cornell.txt")
    ref_img = read_png(golden_png).astype("float32") / 255.0

    def golden_psnr(r):
        mine = np.clip(r.linear_image(), 0, 1)[:, ::-1, :]
        return round(
            10.0 * math.log10(1.0 / float(((mine - ref_img) ** 2).mean())), 2
        )

    out = {"depths": {}, "iters": args.iters, "chunk": args.chunk}

    # ── quality arms ──
    if not args.skip_quality:
        for d in args.depths:
            r = Renderer(
                golden_scene,
                RenderConfig(
                    samples_per_launch=args.chunk, antialias=True,
                    sampler="sobol", ld_depths=d,
                ),
            )
            r.render(200)
            p200 = golden_psnr(r)
            r.render(800)
            p1000 = golden_psnr(r)
            out["depths"][d] = {"psnr_200": p200, "psnr_1000": p1000}
            print(f"ld_depths={d}: {p200} dB @200, {p1000} dB @1000",
                  flush=True)

    # ── speed arms (alternating best-of-3 on the headline config) ──
    if not args.skip_speed:
        rs = {
            d: Renderer(
                cornell,
                RenderConfig(
                    samples_per_launch=args.chunk, sampler="sobol",
                    ld_depths=d,
                ),
            )
            for d in args.depths
        }
        for d, r in rs.items():
            r.step(args.chunk)  # compile outside timing
        best = {d: float("inf") for d in args.depths}
        for lap in range(3):
            for d, r in rs.items():
                r.reset()
                t0 = time.perf_counter()
                r.render(args.iters)
                best[d] = min(best[d], time.perf_counter() - t0)
        for d, r in rs.items():
            rays = r.scene.camera.pixel_count * args.iters / best[d]
            out["depths"].setdefault(d, {})["mrays"] = round(rays / 1e6, 1)
            print(f"ld_depths={d}: {rays / 1e6:.1f} M rays/s", flush=True)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
