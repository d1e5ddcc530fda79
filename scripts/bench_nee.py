"""Quality benchmark: NEE+MIS convergence vs plain BRDF sampling (GPU).

The direct-light-sampling extension (ops/lights.py — the working version of
the reference's dead ``dev_lightPositions`` machinery, `pathtrace.cu:454-456,
491-504`) changes the estimator's variance, not its mean. This script
quantifies the convergence win the way a user would see it: PSNR against the
converged 5000-spp golden after a fixed (small) sample budget, with and
without NEE, on the upstream starter scene.

    python scripts/bench_nee.py [--iters 200] [--chunk 10]

Prints one JSON line per arm: {"nee": bool, "psnr_db": N, "wall_s": N}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=10,
                    help="samples per launch")
    ap.add_argument("--pipeline", default="auto",
                    choices=["auto", "fast", "reference"])
    args = ap.parse_args()
    from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
        enable_compile_cache,
    )

    device.require_gpu()
    enable_compile_cache()
    print(f"card: {' | '.join(device.card_lines())}")

    from cosc_4397_pathtracing_raytracing_project_tpu import (
        RenderConfig,
        Renderer,
    )
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png

    golden = read_png(
        os.path.join(REPO, "tests", "data", "REFERENCE_cornell.5000samp.png")
    ).astype("float32") / 255.0
    scene = os.path.join(REPO, "scenes", "cornell_golden.txt")

    for nee in (False, True):
        r = Renderer(
            scene,
            RenderConfig(
                samples_per_launch=args.chunk,
                antialias=True,
                pipeline=args.pipeline,
                nee=nee,
            ),
        )
        r.step(args.chunk)  # compile outside the timed region
        # best-of-3 laps
        wall = float("inf")
        for _ in range(3):
            r.reset()
            t0 = time.perf_counter()
            r.render(args.iters)
            mine = np.clip(r.linear_image(), 0, 1)[:, ::-1, :]
            wall = min(wall, time.perf_counter() - t0)
        psnr = 10.0 * math.log10(1.0 / float(((mine - golden) ** 2).mean()))
        print(
            json.dumps(
                {
                    "nee": nee,
                    "pipeline": args.pipeline,
                    "iters": args.iters,
                    "psnr_db": round(psnr, 2),
                    "wall_s": round(wall, 2),
                    "mrays": round(
                        r.scene.camera.pixel_count * args.iters / wall / 1e6,
                        1,
                    ),
                }
            )
        )


if __name__ == "__main__":
    main()
