"""Small vectorized linear-algebra helpers shared by the ray ops.

Points/directions are ``[..., 3]`` float32 arrays; mat4s are ``[..., 4, 4]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Geometry transforms need full f32: at default precision a GPU may run a
# matmul/einsum in TF32 (10 mantissa bits, ~3 significant digits), which is
# catastrophic for ray-object intersection (walls vanish, spheres ring).
_PRECISION = jax.lax.Precision.HIGHEST


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def norm(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(v * v, axis=-1))


def normalize(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    n = norm(v)[..., None]
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def transform_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """``vec3(M @ [p, 1])`` — the reference's multiplyMV with w=1
    (`src/intersections.h:34-36`). Broadcasts over leading dims."""
    return (
        jnp.einsum("...ij,...j->...i", m[..., :3, :3], p, precision=_PRECISION)
        + m[..., :3, 3]
    )


def transform_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``vec3(M @ [v, 0])`` — multiplyMV with w=0."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v, precision=_PRECISION)


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (`src/pathtrace.cu:240-242`)."""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal
