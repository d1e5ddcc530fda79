"""Headline benchmark: Cornell Box 800×800, trace depth 8, one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "detail": {...}}

Baseline: 236 M primary samples/s (the reference CUDA renderer's naive
configuration, README.md:30; "rays/s" = pixels × iterations / wall seconds,
`src/pathtrace.cu:173`). vs_baseline is value / 236e6. `detail` names the
device (JAX platform, kind, count) and the card's name and power limit.

Exits non-zero without a JSON line when JAX finds no GPU: a CPU timing is
not a device metric.

Env knobs: PT_BENCH_ITERS (default 1000), PT_BENCH_CHUNK (samples per
device call, default 200), PT_BENCH_SCENE (scene path), PT_BENCH_SAMPLER
(default "sobol"; "independent" for the plain PRNG streams), PT_BENCH_LAPS
(default 3, best lap reported).
"""

import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BASELINE_RAYS_PER_SEC = 236e6


def main():
    from cosc_4397_pathtracing_raytracing_project_tpu.utils import device
    from cosc_4397_pathtracing_raytracing_project_tpu.utils.cache import (
        enable_compile_cache,
    )

    try:
        device.require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    enable_compile_cache()

    import numpy as np

    from cosc_4397_pathtracing_raytracing_project_tpu import RenderConfig, Renderer
    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png

    iters = int(os.environ.get("PT_BENCH_ITERS", "1000"))
    chunk = int(os.environ.get("PT_BENCH_CHUNK", "200"))
    scene_path = os.environ.get(
        "PT_BENCH_SCENE", os.path.join(REPO, "scenes", "cornell.txt")
    )
    sampler = os.environ.get("PT_BENCH_SAMPLER", "sobol")
    renderer = Renderer(
        scene_path,
        RenderConfig(samples_per_launch=chunk, sampler=sampler),
    )

    # Warm up / compile outside the timed region, then reset device state,
    # the host iteration mirror, and metrics together (resetting only device
    # state would make render(iters) trace iters-chunk samples while rays/s
    # divides by iters).
    renderer.step(chunk)
    renderer.reset()

    laps = int(os.environ.get("PT_BENCH_LAPS", "3"))
    wall = float("inf")
    for _ in range(max(1, laps)):
        renderer.reset()
        t0 = time.perf_counter()
        renderer.render(iters)
        wall = min(wall, time.perf_counter() - t0)

    pixels = renderer.scene.camera.pixel_count
    rays_per_sec = pixels * iters / wall

    # Golden-image PSNR (the quality gate): render the upstream starter
    # configuration and compare against its 5000-sample reference.
    ref_img = read_png(
        os.path.join(REPO, "tests", "data", "REFERENCE_cornell.5000samp.png")
    ).astype("float32") / 255.0
    rg = Renderer(
        os.path.join(REPO, "scenes", "cornell_golden.txt"),
        RenderConfig(samples_per_launch=chunk, antialias=True, sampler=sampler),
    )
    rg.render(min(iters, 1000))
    mine = np.clip(rg.linear_image(), 0, 1)[:, ::-1, :]
    psnr_golden = 10.0 * math.log10(1.0 / float(((mine - ref_img) ** 2).mean()))

    result = {
        "metric": "primary_samples_per_sec_cornell_800x800_depth8",
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / BASELINE_RAYS_PER_SEC,
        "detail": {
            "iterations": iters,
            "wall_seconds": wall,
            "pixels": pixels,
            "chunk": chunk,
            "sampler": sampler,
            "device": device.device_record(),
            "card": device.card_lines(),
            "psnr_vs_golden_db": psnr_golden,
            "golden_spp": rg.iteration,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
