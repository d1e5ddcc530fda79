"""Feature-guided denoiser: AOV pass + edge-avoiding À-Trous wavelet filter.

Extension — the reference ships raw accumulator means only (`finalGather`,
`src/pathtrace.cu:439-444`); there is no denoiser to port. This is the
standard companion subsystem of a production path tracer, built the XLA
way: the filter is ~125 statically-unrolled shifted multiply-adds over the
whole [H, W] image (5 levels × 5×5 taps), which XLA fuses into a handful of
elementwise kernels — no gathers, no data-dependent control flow, runs on
any backend (GPU/CPU) and under jit/shard_map unchanged.

Design (Dammertz et al., "Edge-Avoiding À-Trous Wavelet Transform for Fast
Global Illumination Filtering", HPG 2010, plus the albedo demodulation step
popularized by SVGF/OIDN):

- An AOV pass traces ONE center primary ray per pixel (`render_aovs`) and
  records first-hit albedo, shading normal, and depth. It reuses the
  readable wavefront intersector (`ops.intersect.intersect_scene` — the
  same code path the golden tests pin), chunked with `lax.map` so the
  [N, T] candidate matrices stay bounded on big scenes.
- The noisy radiance is DEMODULATED by albedo before filtering (texture
  detail is noise-free — it comes from the AOV, not the estimator — so it
  must not be smoothed), filtered in irradiance space, then re-modulated.
- Each À-Trous level doubles the tap spacing (dilation 2^l) and filters
  with the 5×5 B3-spline kernel, modulated per tap by feature weights:
  normal alignment (cosine^sigma_n), relative depth proximity, albedo
  proximity, and irradiance proximity (the only noisy guide — its sigma
  tightens 2× per level, Dammertz §4.2, so late wide taps can't bleed
  across illumination edges). Sky/miss pixels form their own weight class
  (hit↔miss taps get weight 0), so the envmap never smears onto geometry.

The filter preserves constants exactly (weights are normalized, the center
tap weight is 1), so a converged render passes through nearly unchanged
while low-spp renders gain several dB (measured: tests/test_denoise.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intersect import intersect_scene, take_rows
from ..scene.structs import Scene

_MISS_DEPTH = 0.0  # miss pixels: depth 0 + synthetic normal, own weight class
_MISS_NORMAL = (0.0, 0.0, 1.0)


class Aovs(NamedTuple):
    """Per-pixel first-hit feature buffers, [H, W, ...] in image layout
    (row y=0 first, matching `Renderer.linear_image`)."""

    albedo: jnp.ndarray  # [H, W, 3] material diffuse color (1 on miss)
    normal: jnp.ndarray  # [H, W, 3] unit shading normal ((0,0,1) on miss)
    depth: jnp.ndarray  # [H, W] world-space hit distance (0 on miss)
    miss: jnp.ndarray  # [H, W] bool


def _center_rays(camera, idx: jnp.ndarray):
    """Center primary ray per pixel index (reference raygen at the pixel
    corner, `src/pathtrace.cu:270-286` — no jitter: AOVs must be
    noise-free). Componentwise like ops.fast's raygen."""
    w, h = camera.resolution
    px = (idx % w).astype(jnp.float32)
    py = (idx // w).astype(jnp.float32)
    sx = camera.pixel_length[0] * (px - 0.5 * w)
    sy = camera.pixel_length[1] * (py - 0.5 * h)
    d = (
        camera.view[None, :]
        - camera.right[None, :] * sx[:, None]
        - camera.up[None, :] * sy[:, None]
    )
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    o = jnp.broadcast_to(camera.position[None, :], d.shape)
    return o, d


@partial(jax.jit, static_argnames=("chunk",))
def _aov_pass(scene: Scene, chunk: int) -> Aovs:
    cam = scene.camera
    w, h = cam.resolution
    n = cam.pixel_count
    pad = (-n) % chunk

    def one_chunk(idx):
        o, d = _center_rays(cam, idx)
        hit = intersect_scene(scene, o, d)
        albedo = take_rows(scene.materials.color, hit.material_id)
        albedo = jnp.where(hit.miss[:, None], 1.0, albedo)
        normal = jnp.where(
            hit.miss[:, None], jnp.asarray(_MISS_NORMAL), hit.normal
        )
        depth = jnp.where(hit.miss, _MISS_DEPTH, hit.t)
        return albedo, normal, depth, hit.miss

    idx = jnp.arange(n + pad, dtype=jnp.int32).reshape(-1, chunk)
    albedo, normal, depth, miss = jax.lax.map(one_chunk, idx)
    return Aovs(
        albedo=albedo.reshape(-1, 3)[:n].reshape(h, w, 3),
        normal=normal.reshape(-1, 3)[:n].reshape(h, w, 3),
        depth=depth.reshape(-1)[:n].reshape(h, w),
        miss=miss.reshape(-1)[:n].reshape(h, w),
    )


def render_aovs(scene: Scene, chunk: int = 1 << 16) -> Aovs:
    """Trace the per-pixel feature buffers (one center primary ray each).

    `chunk` bounds the pixels×primitives candidate matrix of the readable
    intersector; on triangle scenes it is additionally capped so the
    [chunk, T] Möller-Trumbore candidate block stays ≤ ~0.5 GB (the
    38.5k-tri bench mesh at the default chunk would otherwise build a
    10 GB intermediate). The pass runs once per camera pose, not per
    sample, so the extra `lax.map` steps are immaterial."""
    t = int(scene.triangles.count)
    if t > 0:
        chunk = min(chunk, max(256, (1 << 27) // t))
    return _aov_pass(scene, min(chunk, scene.camera.pixel_count))


# ── the filter ─────────────────────────────────────────────────────────────

# 1-D B3-spline mask; the 5×5 kernel is its outer product (Dammertz §3).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _luma(rgb: jnp.ndarray) -> jnp.ndarray:
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


def _despeckle(irr: jnp.ndarray) -> jnp.ndarray:
    """Firefly clamp: limit each pixel to its brightest 8-neighborhood
    value (per channel). An isolated outlier — a low-probability path that
    will not recur for thousands of samples — drops to its surroundings;
    any genuine bright REGION (>= 2 px wide) keeps bright neighbors and
    passes through. Needed because the À-Trous color weight *protects*
    outliers (a firefly differs from every neighbor, so all its weights
    vanish and it survives filtering untouched)."""
    h, w, _ = irr.shape
    p = jnp.pad(irr, ((1, 1), (1, 1), (0, 0)), mode="edge")
    neigh = None
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            s = jax.lax.slice(p, (dy, dx, 0), (dy + h, dx + w, 3))
            neigh = s if neigh is None else jnp.maximum(neigh, s)
    return jnp.minimum(irr, neigh)


@partial(
    jax.jit,
    static_argnames=(
        "levels", "sigma_color", "sigma_normal", "sigma_depth",
        "sigma_albedo", "defirefly",
    ),
)
def atrous_denoise(
    color: jnp.ndarray,
    aovs: Aovs,
    *,
    levels: int = 5,
    sigma_color: float = 0.30,
    sigma_normal: float = 64.0,
    sigma_depth: float = 0.02,
    sigma_albedo: float = 0.15,
    defirefly: bool = True,
) -> jnp.ndarray:
    """Edge-avoiding À-Trous filter over a linear [H, W, 3] radiance image.

    sigma_color: irradiance-luminance tolerance at level 0 (halves per
    level); sigma_normal: cosine sharpness exponent; sigma_depth: relative
    depth tolerance (scaled by the center depth, so it is scene-scale
    free); sigma_albedo: rgb albedo tolerance. All weights are multiplied,
    the center tap has weight 1, and each output pixel renormalizes — so a
    constant region is reproduced exactly and every output is a convex
    combination of inputs (no ringing, no energy invented)."""
    color = jnp.asarray(color, jnp.float32)
    alb = jnp.asarray(aovs.albedo, jnp.float32)
    nrm = jnp.asarray(aovs.normal, jnp.float32)
    dep = jnp.asarray(aovs.depth, jnp.float32)
    missf = aovs.miss.astype(jnp.float32)

    # Demodulate: the AOV carries the texture detail noise-free; filtering
    # irradiance keeps it sharp. Emissive / sky pixels have albedo 1-ish or
    # the clamp floor — the re-modulation is exact either way because the
    # same divisor multiplies back.
    alb_safe = jnp.maximum(alb, 1e-3)
    irr = color / alb_safe
    if defirefly:
        irr = _despeckle(irr)

    h, w, _ = color.shape
    inv_sd = 1.0 / jnp.float32(sigma_depth)
    inv_sa2 = 1.0 / jnp.float32(sigma_albedo) ** 2

    def shift(img, dy, dx, step):
        """Edge-clamped shifted view: img[y + dy*step, x + dx*step]."""
        if dy == 0 and dx == 0:
            return img
        p = 2 * step
        pad = ((p, p), (p, p)) + ((0, 0),) * (img.ndim - 2)
        big = jnp.pad(img, pad, mode="edge")
        return jax.lax.slice(
            big,
            (p + dy * step, p + dx * step) + (0,) * (img.ndim - 2),
            (p + dy * step + h, p + dx * step + w) + img.shape[2:],
        )

    out = irr
    for level in range(levels):
        step = 1 << level
        # Dammertz §4.2: tighten the (noisy) color guide as taps widen.
        sc2 = jnp.float32(sigma_color / (1 << level)) ** 2
        lum_c = _luma(out)
        acc = jnp.zeros_like(out)
        wacc = jnp.zeros((h, w), jnp.float32)
        for iy, hy in enumerate(_B3):
            for ix, hx in enumerate(_B3):
                dy, dx = iy - 2, ix - 2
                q_irr = shift(out, dy, dx, step)
                if dy == 0 and dx == 0:
                    wgt = jnp.full((h, w), hy * hx, jnp.float32)
                else:
                    q_n = shift(nrm, dy, dx, step)
                    q_d = shift(dep, dy, dx, step)
                    q_a = shift(alb, dy, dx, step)
                    q_m = shift(missf, dy, dx, step)
                    w_n = jnp.maximum(jnp.sum(nrm * q_n, axis=-1), 0.0) ** (
                        jnp.float32(sigma_normal)
                    )
                    # relative depth: tolerance scales with the center
                    # depth; the +1 floor keeps near-plane pixels sane
                    w_z = jnp.exp(
                        -jnp.abs(dep - q_d)
                        * inv_sd
                        / jnp.maximum(dep, 1.0)
                    )
                    w_a = jnp.exp(
                        -jnp.sum((alb - q_a) ** 2, axis=-1) * inv_sa2
                    )
                    w_c = jnp.exp(
                        -((lum_c - _luma(q_irr)) ** 2) / sc2
                    )
                    same_class = 1.0 - jnp.abs(missf - q_m)
                    wgt = (hy * hx) * w_n * w_z * w_a * w_c * same_class
                acc = acc + q_irr * wgt[..., None]
                wacc = wacc + wgt
        out = acc / wacc[..., None]

    return out * alb_safe


def denoise_image(
    renderer,
    *,
    levels: int = 5,
    sigma_color: float = 0.30,
    sigma_normal: float = 64.0,
    sigma_depth: float = 0.02,
    sigma_albedo: float = 0.15,
) -> np.ndarray:
    """Denoised [H, W, 3] float32 linear image of a Renderer's current
    accumulator (convenience wrapper: AOV pass + filter)."""
    aovs = render_aovs(renderer.scene)
    img = jnp.asarray(renderer.linear_image())
    return np.asarray(
        atrous_denoise(
            img,
            aovs,
            levels=levels,
            sigma_color=sigma_color,
            sigma_normal=sigma_normal,
            sigma_depth=sigma_depth,
            sigma_albedo=sigma_albedo,
        )
    )
