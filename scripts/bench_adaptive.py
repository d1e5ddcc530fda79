"""Adaptive-sampling quality A/B on the GPU.

Equal-budget comparison on the golden Cornell configuration: uniform fast
render vs render.adaptive's variance-guided allocation, PSNR vs the
converged 5000-sample reference at each budget, with wall time and rate
(run the arms alternately to see the spread):

    python scripts/bench_adaptive.py --spp 128
    python scripts/bench_adaptive.py --spp 128 --arm uniform
    python scripts/bench_adaptive.py --spp 128 --arm adaptive --denoise
"""

import argparse
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=128, help="avg sample budget")
    ap.add_argument("--arm", choices=["uniform", "adaptive", "both"],
                    default="both")
    ap.add_argument("--scene", default=os.path.join(REPO, "scenes",
                                                    "cornell_golden.txt"))
    ap.add_argument("--golden", default=os.path.join(
        REPO, "tests", "data", "REFERENCE_cornell.5000samp.png"))
    ap.add_argument("--sampler", default="sobol")
    ap.add_argument("--nee", action="store_true")
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--round-spp", type=int, default=32)
    ap.add_argument("--frac", type=float, default=0.25)
    ap.add_argument("--warmup-frac", type=float, default=0.25,
                    help="share of the budget spent uniformly first")
    ap.add_argument("--chunk", type=int, default=40)
    args = ap.parse_args()

    from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
        enable_compile_cache,
    )

    device.require_gpu()
    enable_compile_cache()
    print(f"card: {' | '.join(device.card_lines())}")

    import numpy as np

    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png
    from cosc_4397_pathtracing_raytracing_project_tpu.render.adaptive import (
        AdaptiveRenderer,
    )

    ref = read_png(args.golden).astype(np.float32) / 255.0

    def psnr(r):
        lin = r.denoised_image() if args.denoise else r.linear_image()
        mine = np.clip(lin, 0, 1)[:, ::-1, :]
        return 10.0 * math.log10(1.0 / float(((mine - ref) ** 2).mean()))

    cfg = RenderConfig(
        samples_per_launch=args.chunk, antialias=True,
        sampler=args.sampler, nee=args.nee,
    )

    if args.arm in ("uniform", "both"):
        r = Renderer(args.scene, cfg)
        r.step(args.chunk)  # warm the executable
        r.reset()
        t0 = time.perf_counter()
        r.render(args.spp)
        r.sync()
        wall = time.perf_counter() - t0
        print(
            f"uniform  {args.spp:4d} spp  {psnr(r):6.2f} dB  "
            f"{wall:6.2f} s  "
            f"{r.scene.camera.pixel_count * args.spp / wall / 1e6:7.1f} M/s"
        )

    if args.arm in ("adaptive", "both"):
        warm = max(16, int(args.spp * args.warmup_frac))
        # warm every executable the timed run will use by running the
        # identical schedule once on a throwaway instance (same warmup and
        # round shapes — a different sample count is a different kernel)
        a = AdaptiveRenderer(args.scene, cfg)
        a.render(avg_spp=args.spp, warmup_spp=warm,
                 round_spp=args.round_spp, frac=args.frac)
        a.sync()
        # fresh state, identical config (executables now cached)
        a = AdaptiveRenderer(args.scene, cfg)
        t0 = time.perf_counter()
        a.render(
            avg_spp=args.spp,
            warmup_spp=warm,
            round_spp=args.round_spp,
            frac=args.frac,
        )
        a.sync()
        wall = time.perf_counter() - t0
        spp = a.spp_map()
        print(
            f"adaptive {a.avg_spp:6.1f} spp  {psnr(a):6.2f} dB  "
            f"{wall:6.2f} s  {a._lane_budget_spent / wall / 1e6:7.1f} M/s  "
            f"(spp min {spp.min()} max {spp.max()})"
        )


if __name__ == "__main__":
    main()
