"""Pinhole camera ray generation (`src/pathtrace.cu:270-286`).

Rays are produced directly as flat ``[N, 3]`` SoA arrays (pixel index
``idx = x + y*width``) — the array form of the reference's per-thread
PathSegment initialization. Optional sub-pixel jitter enables antialiasing
(the reference shoots every sample through the same pixel corner).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from ..scene.structs import Camera
from . import linalg


def generate_rays(
    camera: Camera,
    jitter: Optional[jnp.ndarray] = None,
    pixel_offset: int = 0,
    num_pixels: Optional[int] = None,
    lens: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Return (origins [N,3], directions [N,3]) for pixels
    [pixel_offset, pixel_offset + N) in row-major order.

    Matches `generateRayFromCamera`:
    ``dir = normalize(view - right*plx*(x - w/2) - up*ply*(y - h/2))``.
    `jitter` is an optional [N,2] array of sub-pixel offsets in [0,1).
    `lens` is an optional [N,2] array of lens-disk uniforms enabling
    thin-lens depth of field (see :func:`thin_lens`).
    """
    w, h = camera.resolution
    n = num_pixels if num_pixels is not None else w * h
    idx = pixel_offset + jnp.arange(n, dtype=jnp.int32)
    x = (idx % w).astype(jnp.float32)
    y = (idx // w).astype(jnp.float32)
    if jitter is not None:
        x = x + jitter[:, 0]
        y = y + jitter[:, 1]
    sx = camera.pixel_length[0] * (x - 0.5 * w)
    sy = camera.pixel_length[1] * (y - 0.5 * h)
    directions = (
        camera.view[None, :]
        - camera.right[None, :] * sx[:, None]
        - camera.up[None, :] * sy[:, None]
    )
    directions = linalg.normalize(directions)
    origins = jnp.broadcast_to(camera.position[None, :], (n, 3))
    if lens is not None:
        origins, directions = thin_lens(camera, origins, directions, lens)
    return origins, directions


def thin_lens(
    camera: Camera,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    lens: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Thin-lens transform of pinhole rays (DOF extension; no reference
    analog — `pathtrace.cu:270-286` is strictly pinhole).

    Each unit pinhole direction ``d`` is traced to the focal plane
    (perpendicular to ``view`` at distance ``camera.focal``): the pierce
    point ``P = o + d · focal/(d·view)`` is what a real lens would image
    sharply. The ray origin then jitters to a concentric lens-disk sample
    of radius ``camera.aperture`` in the (right, up) plane and the
    direction re-aims at ``P`` — points on the focal plane stay sharp,
    everything else blurs with circle-of-confusion ∝ |depth − focal|.
    ``aperture == 0`` degenerates to the pinhole ray (up to one rounding
    of the re-normalization)."""
    # componentwise dot: an einsum at default precision may run as a TF32
    # matmul on a GPU (10 mantissa bits) — geometry math stays exact f32
    ct = (
        directions[:, 0] * camera.view[0]
        + directions[:, 1] * camera.view[1]
        + directions[:, 2] * camera.view[2]
    )
    ft = camera.focal / jnp.maximum(ct, 1e-6)
    focus = origins + directions * ft[:, None]
    r = camera.aperture * jnp.sqrt(lens[:, 0])
    theta = (2.0 * jnp.pi) * lens[:, 1]
    lx = r * jnp.cos(theta)
    ly = r * jnp.sin(theta)
    origins = (
        origins + camera.right[None, :] * lx[:, None]
        + camera.up[None, :] * ly[:, None]
    )
    return origins, linalg.normalize(focus - origins)
