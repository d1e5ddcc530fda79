"""Image-based environment lighting (equirectangular HDR) with importance
sampling.

Extension — the reference's only environment is a hard-coded two-color
gradient sky (`pathtrace.cu:358-362`, mirrored by ops.sampling.sky_color).
This generalizes it to an arbitrary latitude-longitude radiance map with
luminance-proportional importance sampling and MIS against BRDF sampling —
the standard production-renderer IBL stack (PBRT's InfiniteAreaLight).

Design decisions:

- The 2D texel distribution is flattened and sampled through a
  Walker/Vose ALIAS TABLE: one uniform yields the texel in O(1) with two
  row gathers. The standard alternatives cost more as whole-array ops — a
  marginal+conditional CDF pair needs per-lane row-dependent [N, W]
  gathers, and a flat-CDF ``jnp.searchsorted`` lowers to log₂(H·W)
  *sequential* dynamic-slice rounds. The leftover conditional fraction of
  the draw is re-used as the within-texel azimuth offset, one uniform
  cheaper.
- Texel weights use the texel's EXACT solid angle (cosθ₀ − cosθ₁ band
  integral), so the sampler's ``E[L/pdf]`` equals the Riemann texel sum of
  the map exactly — which the tests pin.
- Radiance lookups are bilinear (wrap in azimuth, clamp at the poles); the
  pdf stays piecewise-constant per texel. A luminance floor (1e-3 of the
  mean) keeps the pdf positive wherever bilinear radiance can be nonzero,
  so the MIS estimator stays unbiased around hard bright/dark edges.

Direction convention (documented for asset authors): ``v = θ/π`` with
``θ = acos(d.y)`` (image row 0 = straight up), ``u = 0.5 + atan2(d.x, −d.z)
/ 2π`` (image center column = the −Z horizon the reference camera faces).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax.numpy as jnp

from ..utils.pytree import PyTreeNode

_TWO_PI = 6.283185307179586
_PI = 3.14159265358979323846


class EnvMap(PyTreeNode):
    """Device-side environment map + sampling tables (all dynamic leaves,
    so swapping maps of equal resolution never recompiles).

    Texel selection uses a Walker/Vose ALIAS TABLE, not a CDF binary
    search: ``jnp.searchsorted`` lowers to log₂(H·W) sequential
    dynamic-slice rounds (~15 for a 128×256 map); the alias draw is two
    row gathers, O(1)."""

    img: jnp.ndarray  # (H, W, 3) f32 linear radiance
    alias_prob: jnp.ndarray  # (H*W,) f32 stay-probability per cell
    alias_idx: jnp.ndarray  # (H*W,) i32 alias partner per cell
    pdf: jnp.ndarray  # (H, W) f32 solid-angle pdf of each texel
    strength: jnp.ndarray  # () f32 radiance multiplier

    @property
    def shape(self):
        return self.img.shape[:2]


def build_envmap(image: np.ndarray, strength: float = 1.0) -> EnvMap:
    """Host-side table build from an [H, W, 3] linear radiance array."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"envmap image must be [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    # Blur the sampling luminance with the 3×3 tent that matches the
    # bilinear lookup footprint (wrap in azimuth, clamp at the poles).
    # Without this, ~44% of a 1-texel sun's *bilinear* mass lies in
    # neighboring texels whose pdf would be near zero — BRDF-sampled rays
    # through that smear get MIS weight ≈ 1 while env sampling also counts
    # the sun, a measured +38% bias on a hard-sun map (the same reason
    # PBRT's InfiniteAreaLight blurs its distribution image).
    def tent(a, axis, wrap):
        lo = np.roll(a, 1, axis) if wrap else np.concatenate(
            [a[:1], a[:-1]], axis=0
        )
        hi = np.roll(a, -1, axis) if wrap else np.concatenate(
            [a[1:], a[-1:]], axis=0
        )
        return 0.25 * lo + 0.5 * a + 0.25 * hi

    lum = tent(tent(lum, 0, wrap=False), 1, wrap=True)
    # pdf floor: keep every texel minimally sampleable (zero-radiance
    # regions can still matter through the bilinear tail + MIS)
    lum = np.maximum(lum, 1e-3 * max(float(lum.mean()), 1e-12))
    # exact per-row texel solid angle: Δφ · ∫ sinθ dθ over the row's band
    theta_edges = np.linspace(0.0, _PI, h + 1)
    band = np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:])  # (H,)
    omega = (band * (_TWO_PI / w)).astype(np.float64)  # (H,) per texel
    weights = lum.astype(np.float64) * omega[:, None]
    total = weights.sum()
    if not np.isfinite(total) or total <= 0.0:
        raise ValueError("envmap has no positive finite luminance")
    pdf = (weights / total) / omega[:, None]  # solid-angle density per texel
    prob, alias = _build_alias(weights.ravel() / total)
    return EnvMap(
        img=jnp.asarray(img),
        alias_prob=jnp.asarray(prob, jnp.float32),
        alias_idx=jnp.asarray(alias, jnp.int32),
        pdf=jnp.asarray(pdf, jnp.float32),
        strength=jnp.asarray(float(strength), jnp.float32),
    )


def _build_alias(p: np.ndarray):
    """Vose's O(n) alias-table construction for the discrete texel
    distribution ``p`` (sums to 1).

    The build is inherently sequential (each step mutates one large cell's
    remaining weight), so production-size maps route to the native C++
    runtime (`pt_build_alias`) — ~100 ms for a 2048×4096 HDR's 8.4M texels.
    The pure-Python fallback uses preallocated numpy stacks (~4× the list
    version) but is still a Python loop: ~10 s at 8.4M texels, fine for the
    ≤512×1024 maps the tests and bundled scenes use."""
    n = p.size
    try:
        from ..native import runtime as native_runtime

        native = native_runtime.build_alias(p)
        if native is not None:
            return native
    except Exception:
        pass
    scaled = p.astype(np.float64) * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    # index stacks as preallocated arrays + pointers (no list churn)
    small = np.flatnonzero(scaled < 1.0)
    large = np.flatnonzero(scaled >= 1.0)
    stack = np.concatenate([small, large, np.zeros(1, np.int64)])
    n_small, n_large = small.size, large.size
    # lay out: small grows down from n_small, large grows down from the end
    small_top, large_top = n_small, n_small + n_large
    while small_top > 0 and large_top > n_small:
        small_top -= 1
        s = stack[small_top]
        large_top -= 1
        l = stack[large_top]
        prob[s] = scaled[s]
        alias[s] = l
        w = (scaled[l] + scaled[s]) - 1.0
        scaled[l] = w
        if w < 1.0:
            stack[small_top] = l
            small_top += 1
        else:
            stack[large_top] = l
            large_top += 1
    # leftovers are 1.0 up to rounding
    return prob, alias


@dataclasses.dataclass
class EnvNEEInputs:
    """Per-bounce inputs for environment importance sampling in
    ops.shade.shade_step (the infinite-light twin of lights.NEEInputs)."""

    env: EnvMap
    shadow_isect: Callable  # (origins, dirs) -> Hit; visibility = .miss
    uniforms: jnp.ndarray  # [N, 2] (rng.env_uniforms)


def dir_to_uv(d: jnp.ndarray):
    """[..., 3] unit directions → (u, v) in [0, 1)² (see module docstring)."""
    u = 0.5 + jnp.arctan2(d[..., 0], -d[..., 2]) * (1.0 / _TWO_PI)
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) * (1.0 / _PI)
    return u, v


def uv_to_dir(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(u, v) → [..., 3] unit directions (exact inverse of dir_to_uv)."""
    theta = v * _PI
    phi = (u - 0.5) * _TWO_PI
    st = jnp.sin(theta)
    return jnp.stack(
        [st * jnp.sin(phi), jnp.cos(theta), -st * jnp.cos(phi)], axis=-1
    )


def env_radiance(env: EnvMap, d: jnp.ndarray) -> jnp.ndarray:
    """Bilinear radiance lookup, [..., 3]·strength. Wraps in azimuth,
    clamps at the poles."""
    h, w = env.shape
    u, v = dir_to_uv(d)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    flat = env.img.reshape(h * w, 3)
    c00 = jnp.take(flat, y0i * w + x0i, axis=0)
    c01 = jnp.take(flat, y0i * w + x1i, axis=0)
    c10 = jnp.take(flat, y1i * w + x0i, axis=0)
    c11 = jnp.take(flat, y1i * w + x1i, axis=0)
    top = c00 + (c01 - c00) * tx[..., None]
    bot = c10 + (c11 - c10) * tx[..., None]
    return (top + (bot - top) * ty[..., None]) * env.strength


def env_pdf(env: EnvMap, d: jnp.ndarray) -> jnp.ndarray:
    """Solid-angle pdf with which :func:`sample_env` generates direction
    ``d`` (piecewise-constant per texel) — the BRDF side of the MIS pair."""
    h, w = env.shape
    u, v = dir_to_uv(d)
    x = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return jnp.take(env.pdf.reshape(-1), y * w + x, axis=0)


def sample_env(env: EnvMap, u1: jnp.ndarray, u2: jnp.ndarray):
    """Draw environment directions ∝ luminance·solid-angle.

    Returns ``(directions [..., 3], radiance [..., 3] (nearest texel,
    ×strength), pdf [...])``. Nearest-texel radiance makes the returned
    (radiance, pdf) pair exactly consistent: E[radiance/pdf] is the texel
    Riemann sum with zero variance in the texel choice."""
    h, w = env.shape
    n_tex = h * w
    # alias draw: cell from the integer part of u1·n, stay/alias from the
    # fractional part — two gathers, no log(n) search. The leftover
    # conditional fraction is re-used as the within-texel azimuth offset
    # (uniform on [0,1) given the branch; its granularity is the f32
    # mantissa left after n_tex, ≥ 9 bits for maps up to 128×256 —
    # sub-texel azimuth dither, visually irrelevant far below that).
    scaled = u1 * n_tex
    cell = jnp.clip(scaled.astype(jnp.int32), 0, n_tex - 1)
    f = jnp.clip(scaled - cell.astype(jnp.float32), 0.0, 1.0 - 1e-7)
    p_stay = jnp.take(env.alias_prob, cell)
    take_alias = f >= p_stay
    idx = jnp.where(take_alias, jnp.take(env.alias_idx, cell), cell)
    xfrac = jnp.where(
        take_alias,
        (f - p_stay) / jnp.maximum(1.0 - p_stay, 1e-12),
        f / jnp.maximum(p_stay, 1e-12),
    )
    xfrac = jnp.clip(xfrac, 0.0, 1.0 - 1e-6)
    y = idx // w
    x = idx - y * w
    u = (x.astype(jnp.float32) + xfrac) / w
    # Polar offset uniform in SOLID ANGLE within the texel's latitude band
    # (inverse of the band's cos integral), NOT uniform in v: that makes the
    # pointwise generation density exactly the piecewise-constant table pdf,
    # so the MIS weights and env_pdf() are exact (uniform-in-v sampling
    # only matches the texel-average density, which biases the estimator
    # wherever the integrand varies within a texel).
    yf = y.astype(jnp.float32)
    cos0 = jnp.cos(yf * (_PI / h))
    cos1 = jnp.cos((yf + 1.0) * (_PI / h))
    cos_t = cos0 + u2 * (cos1 - cos0)
    theta = jnp.arccos(jnp.clip(cos_t, -1.0, 1.0))
    phi = (u - 0.5) * _TWO_PI
    st = jnp.sin(theta)
    d = jnp.stack(
        [st * jnp.sin(phi), cos_t, -st * jnp.cos(phi)], axis=-1
    )
    radiance = jnp.take(env.img.reshape(n_tex, 3), idx, axis=0) * env.strength
    pdf = jnp.take(env.pdf.reshape(-1), idx)
    return d, radiance, pdf
