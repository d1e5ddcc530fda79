"""BRDF direction sampling (`src/pathtrace.cu:209-248,398-436`), vectorized.

All samplers take pre-drawn uniforms (see ops.rng) so the whole shade stage is
a pure function of ``(state, uniforms)`` — the functional replacement for the
reference's stateful per-thread RNG engines.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import linalg

_PI = 3.14159265358979323846


def local_coordinate_system(normal: jnp.ndarray):
    """Branchless port of createLocalCoordinateSystem (`pathtrace.cu:216-223`):
    tangent = |n.x|>|n.y| ? normalize(n.z,0,-n.x) : normalize(0,-n.z,n.y);
    bitangent = cross(n, tangent)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    zeros = jnp.zeros_like(nx)
    t_a = jnp.stack([nz, zeros, -nx], axis=-1)
    t_b = jnp.stack([zeros, -nz, ny], axis=-1)
    use_a = (jnp.abs(nx) > jnp.abs(ny))[..., None]
    tangent = linalg.normalize(jnp.where(use_a, t_a, t_b), eps=1e-20)
    bitangent = linalg.cross(normal, tangent)
    return tangent, bitangent


def cosine_weighted_hemisphere(
    u1: jnp.ndarray, u2: jnp.ndarray, normal: jnp.ndarray
) -> jnp.ndarray:
    """sampleCosineWeightedHemisphere (`pathtrace.cu:225-238`): frame axes are
    (tangent, normal, bitangent) with theta = acos(sqrt(1-u1))."""
    tangent, bitangent = local_coordinate_system(normal)
    theta = jnp.arccos(jnp.sqrt(jnp.maximum(1.0 - u1, 0.0)))
    phi = 2.0 * _PI * u2
    sin_t = jnp.sin(theta)
    x = sin_t * jnp.cos(phi)
    y = jnp.cos(theta)
    z = sin_t * jnp.sin(phi)
    return linalg.normalize(
        tangent * x[..., None] + normal * y[..., None] + bitangent * z[..., None]
    )


def perturbed_specular(
    incident: jnp.ndarray,
    normal: jnp.ndarray,
    roughness: jnp.ndarray,
    u_angle: jnp.ndarray,
    u_azimuth: jnp.ndarray,
) -> jnp.ndarray:
    """Mirror reflection with cone perturbation (`pathtrace.cu:404-414`):
    angle = roughness * u * pi/2 around the reflected direction. At
    roughness == 0 this reduces exactly to the pure mirror direction, so it is
    applied unconditionally (branchless) unlike the reference's `if`."""
    reflect_dir = linalg.reflect(incident, normal)
    tangent, bitangent = local_coordinate_system(reflect_dir)
    angle = roughness * u_angle * _PI * 0.5
    phi = 2.0 * _PI * u_azimuth
    sin_a = jnp.sin(angle)
    x = sin_a * jnp.cos(phi)
    y = jnp.cos(angle)
    z = sin_a * jnp.sin(phi)
    return linalg.normalize(
        tangent * x[..., None]
        + reflect_dir * y[..., None]
        + bitangent * z[..., None]
    )


def sky_color(directions: jnp.ndarray) -> jnp.ndarray:
    """Gradient environment light (`pathtrace.cu:358-362`):
    lerp(white, (0.5,0.7,1.0), 0.5*(dir.y+1)) * 0.5."""
    t = 0.5 * (directions[..., 1] + 1.0)
    horizon = jnp.array([1.0, 1.0, 1.0], jnp.float32)
    zenith = jnp.array([0.5, 0.7, 1.0], jnp.float32)
    sky = (1.0 - t)[..., None] * horizon + t[..., None] * zenith
    return sky * 0.5


def schlick_fresnel(cos_theta, n1, n2):
    """Schlick approximation (`pathtrace.cu:244-248`; defined but unused in
    the reference's final shading — provided for the refraction extension)."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
