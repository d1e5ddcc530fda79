"""Environment-lighting benchmark: throughput + quality on the GPU.

Renders `scenes/env_spheres.txt` (800×800, HDR meadow map) two ways and
reports steady-state throughput plus PSNR against a high-spp unbiased
reference render:

  exact        — bilinear HDR lookups, BRDF sampling only (fast pipeline)
  exact+nee    — + alias-table importance sampling + MIS  (fast pipeline)

Run from the repo root:  python scripts/bench_env.py [--spp 64] [--ref-spp 512]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cosc_4397_pathtracing_raytracing_project_tpu import (  # noqa: E402
    Renderer,
    RenderConfig,
)
from cosc_4397_pathtracing_raytracing_project_tpu.scene.parser import (  # noqa: E402
    load_scene_desc,
)


def _run(desc, cfg, spp, chunk, seed=0):
    r = Renderer(desc, cfg, seed=seed)
    r.step(min(chunk, spp))  # compile
    r.reset()
    t0 = time.perf_counter()
    r.render(spp)
    r.sync()
    wall = time.perf_counter() - t0
    img = np.asarray(r.linear_image())
    n = img.shape[0] * img.shape[1]
    return img, n * spp / wall


def psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="scenes/env_spheres.txt")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--ref-spp", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=16)
    args = ap.parse_args()
    from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
        enable_compile_cache,
    )

    device.require_gpu()
    enable_compile_cache()
    print(f"card: {' | '.join(device.card_lines())}")

    desc = load_scene_desc(args.scene)
    common = dict(samples_per_launch=args.chunk, enable_refraction=True)

    print(f"reference: exact+nee @ {args.ref_spp} spp …", flush=True)
    ref, _ = _run(desc, RenderConfig(nee=True, **common), args.ref_spp,
                  args.chunk, seed=99)

    # chunk must divide spp: a trailing odd-size launch is a fresh
    # computation shape whose compile would land inside the timed region
    configs = [
        ("exact", RenderConfig(**common)),
        ("exact+nee", RenderConfig(nee=True, **common)),
    ]
    for name, cfg in configs:
        img, rays = _run(desc, cfg, args.spp, cfg.samples_per_launch)
        print(
            f"{name:10s} {args.spp:4d} spp   {rays / 1e6:7.1f} M rays/s   "
            f"{psnr(img, ref):5.2f} dB vs reference",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
