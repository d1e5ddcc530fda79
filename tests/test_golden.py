"""Golden-image regression: region radiances of a low-res light_only render
must match the upstream reference render `img/REFERENCE_cornell.5000samp.png`.

The region values below were measured from that golden PNG (800×800, linear,
mirrored save orientation) and independently reproduced by this renderer to
±0.005 at convergence. At 128×128 / 100 samples the Monte Carlo error of a
region mean is well under the 15% tolerance used here."""

import numpy as np
import pytest

from cosc_4397_pathtracing_raytracing_project_tpu import Renderer, RenderConfig
from cosc_4397_pathtracing_raytracing_project_tpu.scene import parse_scene

# (row slice, col slice) in the 128×128 mirrored image → golden linear RGB
GOLDEN_REGIONS = {
    "red wall": ((slice(56, 72), slice(12, 20)), [0.148, 0.067, 0.054]),
    "green wall": ((slice(56, 72), slice(108, 116)), [0.067, 0.151, 0.055]),
    "floor": ((slice(112, 122), slice(56, 72)), [0.178, 0.180, 0.153]),
    "ceiling": ((slice(10, 20), slice(56, 72)), [0.104, 0.105, 0.075]),
    "sphere": ((slice(62, 75), slice(50, 62)), [0.197, 0.176, 0.156]),
}


@pytest.fixture(scope="module")
def golden_render():
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell_golden.txt")
    text = open(path).read().replace("RES         800 800", "RES         128 128")
    r = Renderer(
        parse_scene(text),
        RenderConfig(samples_per_launch=25, gather_mode="light_only", antialias=True),
    )
    r.render(100)
    return np.clip(r.linear_image(), 0, 1)[:, ::-1, :]


@pytest.mark.parametrize("region", list(GOLDEN_REGIONS))
def test_region_matches_golden(golden_render, region):
    (ys, xs), want = GOLDEN_REGIONS[region]
    got = golden_render[ys, xs].mean(axis=(0, 1))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0.15, atol=0.02)


@pytest.mark.slow  # ~2.5 min on CPU; the per-region golden pins stay in
# the fast lap and catch the same estimator drift
def test_full_image_psnr_vs_golden():
    """Full-image PSNR gate against the upstream golden (not just region
    means): render 160² (800/160 = 5, so the golden downsamples by exact 5×5
    block mean in linear space — both images are box-filtered estimates of
    the same radiance) and require PSNR above the 200-spp Monte Carlo noise
    floor minus margin. Recorded estimator values: 26.96 dB @ 200 spp
    (pure-MC slope: 23.9 @ 100, 29.9 @ 400); converged evidence: 39.4 dB
    @ 100k spp, limited by the golden's own 5000-spp noise."""
    import math
    import os

    from cosc_4397_pathtracing_raytracing_project_tpu.io.png import read_png

    here = os.path.dirname(__file__)
    golden = (
        read_png(os.path.join(here, "data", "REFERENCE_cornell.5000samp.png")).astype(
            np.float32
        )
        / 255.0
    )
    g160 = golden.reshape(160, 5, 160, 5, 3).mean(axis=(1, 3))
    path = os.path.join(here, "..", "scenes", "cornell_golden.txt")
    text = open(path).read().replace("RES         800 800", "RES         160 160")
    r = Renderer(
        parse_scene(text), RenderConfig(samples_per_launch=50, antialias=True)
    )
    r.render(200)
    img = np.clip(r.linear_image(), 0, 1)[:, ::-1, :]
    mse = float(((img - g160) ** 2).mean())
    psnr = 10 * math.log10(1.0 / mse)
    assert psnr > 25.5, f"full-image PSNR {psnr:.2f} dB below gate"


def test_estimator_modes_differ(golden_render):
    """throughput mode (reference-code parity) is far brighter than the
    correct estimator — the two must not be silently conflated."""
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "scenes", "cornell_golden.txt")
    text = open(path).read().replace("RES         800 800", "RES         64 64")
    r = Renderer(
        parse_scene(text),
        RenderConfig(samples_per_launch=10, gather_mode="throughput"),
    )
    r.render(20)
    legacy_mean = r.linear_image().mean()  # unclipped: throughput ≫ light-only
    assert legacy_mean > 1.5 * golden_render.mean()
