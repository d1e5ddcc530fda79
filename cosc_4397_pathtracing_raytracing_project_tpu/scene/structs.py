"""Scene data model.

Host side: plain-dataclass ``SceneDesc`` built by the parser (NumPy arrays).
Device side: frozen dataclass pytrees (``utils.pytree``) in structure-of-
arrays layout — a vector-friendly redesign of the reference's array-of-structs PODs
(`src/sceneStructs.h:10-83`). Geometry is *partitioned by primitive type*
(cubes / spheres / triangles) at build time so the intersectors run as dense
vectorized batches with no per-lane type dispatch, unlike the reference's
per-thread branch (`src/pathtrace.cu:311-313`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp
from ..utils import pytree

from . import transforms

# Primitive type ids (reference enum GeomType, `src/sceneStructs.h:10-13`)
CUBE = 0
SPHERE = 1
TRIANGLE = 2  # extension: the reference declares but never populates triangles


# ─────────────────────────── host-side description ───────────────────────────


@dataclasses.dataclass
class CameraDesc:
    """Raw camera parameters as parsed (`src/scene.cpp:92-151`)."""

    resolution: Tuple[int, int]  # (width, height)
    fovy_deg: float
    eye: np.ndarray  # (3,)
    lookat: np.ndarray  # (3,)
    up: np.ndarray  # (3,)
    # Extension: thin-lens depth of field (the reference camera is strictly
    # pinhole, `scene.cpp:92-151`). aperture = lens radius in world units
    # (0 = pinhole); focal = focal-plane distance along view (≤0 = auto:
    # focus on LOOKAT).
    aperture: float = 0.0
    focal: float = 0.0


@dataclasses.dataclass
class SceneDesc:
    """Host-side parsed scene: NumPy SoA + render settings.

    Produced by :mod:`.parser`; converted to device pytrees by
    :meth:`Scene.from_desc`.
    """

    # geometry (G entries)
    geom_type: np.ndarray  # (G,) int32
    material_id: np.ndarray  # (G,) int32
    translation: np.ndarray  # (G, 3)
    rotation: np.ndarray  # (G, 3) degrees
    scale: np.ndarray  # (G, 3)
    transform: np.ndarray  # (G, 4, 4)
    inv_transform: np.ndarray  # (G, 4, 4)
    inv_transpose: np.ndarray  # (G, 4, 4)
    # materials (M entries) — fields per `src/sceneStructs.h:38-49`
    color: np.ndarray  # (M, 3)
    specular_exponent: np.ndarray  # (M,)
    specular_color: np.ndarray  # (M, 3)
    reflectivity: np.ndarray  # (M,)  "hasReflective": mirror-branch probability
    refractive: np.ndarray  # (M,)   "hasRefractive": 1 - roughness in reference
    ior: np.ndarray  # (M,)
    emittance: np.ndarray  # (M,)
    # camera + run settings (CAMERA block, `src/scene.cpp:99-115`)
    camera: CameraDesc = None
    iterations: int = 0
    trace_depth: int = 8
    image_name: str = "render"
    # triangle mesh extension (empty for reference-format scenes)
    tri_vertices: Optional[np.ndarray] = None  # (T, 3, 3) world-space
    tri_material_id: Optional[np.ndarray] = None  # (T,) int32
    # environment-map extension (ENVIRONMENT block; ops/envmap.py) — the
    # reference's environment is a hard-coded gradient (`pathtrace.cu:358-362`)
    env_image: Optional[np.ndarray] = None  # (H, W, 3) f32 linear radiance
    env_strength: float = 1.0

    @property
    def num_geoms(self) -> int:
        return int(self.geom_type.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.color.shape[0])

    @property
    def num_triangles(self) -> int:
        return 0 if self.tri_vertices is None else int(self.tri_vertices.shape[0])


# ─────────────────────────── device-side pytrees ───────────────────────────


class Materials(pytree.PyTreeNode):
    """SoA material table, one row per material (`src/sceneStructs.h:38-49`)."""

    color: jnp.ndarray  # (M, 3) f32
    specular_color: jnp.ndarray  # (M, 3) f32
    specular_exponent: jnp.ndarray  # (M,) f32
    reflectivity: jnp.ndarray  # (M,) f32
    refractive: jnp.ndarray  # (M,) f32
    ior: jnp.ndarray  # (M,) f32
    emittance: jnp.ndarray  # (M,) f32


class GeomBatch(pytree.PyTreeNode):
    """A dense batch of same-type primitives (all cubes or all spheres)."""

    material_id: jnp.ndarray  # (K,) i32
    geom_index: jnp.ndarray  # (K,) i32 — original scene OBJECT index
    transform: jnp.ndarray  # (K, 4, 4) f32
    inv_transform: jnp.ndarray  # (K, 4, 4) f32
    inv_transpose: jnp.ndarray  # (K, 4, 4) f32

    @property
    def count(self) -> int:
        return self.material_id.shape[0]


class TriangleBatch(pytree.PyTreeNode):
    """World-space triangle soup (extension beyond the reference's analytic
    primitives; the reference declares triangle fields in `sceneStructs.h:30-35`
    but never fills them)."""

    v0: jnp.ndarray  # (T, 3)
    e1: jnp.ndarray  # (T, 3)  v1 - v0
    e2: jnp.ndarray  # (T, 3)  v2 - v0
    normal: jnp.ndarray  # (T, 3) geometric normal (normalized)
    material_id: jnp.ndarray  # (T,) i32
    geom_index: jnp.ndarray  # (T,) i32

    @property
    def count(self) -> int:
        return self.material_id.shape[0]


class Camera(pytree.PyTreeNode):
    """Derived render camera. Dynamic fields are device arrays so camera moves
    don't retrigger compilation; resolution is static (shapes depend on it)."""

    position: jnp.ndarray  # (3,)
    view: jnp.ndarray  # (3,)
    up: jnp.ndarray  # (3,)
    right: jnp.ndarray  # (3,)
    pixel_length: jnp.ndarray  # (2,)
    resolution: Tuple[int, int] = pytree.field(static=True, default=(0, 0))
    # thin-lens extension (dynamic scalars so refocusing never recompiles);
    # aperture 0 = pinhole, focal = focal-plane distance along `view`
    aperture: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.zeros((), jnp.float32)
    )
    focal: jnp.ndarray = pytree.field(
        default_factory=lambda: jnp.ones((), jnp.float32)
    )

    @property
    def width(self) -> int:
        return self.resolution[0]

    @property
    def height(self) -> int:
        return self.resolution[1]

    @property
    def pixel_count(self) -> int:
        return self.resolution[0] * self.resolution[1]


class Scene(pytree.PyTreeNode):
    """Full device scene: partitioned geometry + materials + camera."""

    cubes: GeomBatch
    spheres: GeomBatch
    triangles: TriangleBatch
    materials: Materials
    camera: Camera
    # environment-map extension (None = the reference's gradient sky).
    # Typed loosely to avoid a scene→ops import at class-definition time;
    # holds an ops.envmap.EnvMap pytree when the scene has an ENVIRONMENT
    # block. None is an empty pytree, so reference-format scenes keep their
    # exact jit signatures.
    envmap: Optional[object] = None

    @classmethod
    def from_desc(cls, desc: SceneDesc) -> "Scene":
        def batch(type_id: int) -> GeomBatch:
            sel = np.nonzero(desc.geom_type == type_id)[0]
            return GeomBatch(
                material_id=jnp.asarray(desc.material_id[sel], jnp.int32),
                geom_index=jnp.asarray(sel, jnp.int32),
                transform=jnp.asarray(desc.transform[sel], jnp.float32),
                inv_transform=jnp.asarray(desc.inv_transform[sel], jnp.float32),
                inv_transpose=jnp.asarray(desc.inv_transpose[sel], jnp.float32),
            )

        ntri = desc.num_triangles
        if ntri:
            v = np.asarray(desc.tri_vertices, np.float32)
            e1 = v[:, 1] - v[:, 0]
            e2 = v[:, 2] - v[:, 0]
            n = np.cross(e1, e2)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            tri_geom_index = desc.num_geoms + np.arange(ntri)
            tris = TriangleBatch(
                v0=jnp.asarray(v[:, 0]),
                e1=jnp.asarray(e1),
                e2=jnp.asarray(e2),
                normal=jnp.asarray(n),
                material_id=jnp.asarray(desc.tri_material_id, jnp.int32),
                geom_index=jnp.asarray(tri_geom_index, jnp.int32),
            )
        else:
            z3 = jnp.zeros((0, 3), jnp.float32)
            zi = jnp.zeros((0,), jnp.int32)
            tris = TriangleBatch(v0=z3, e1=z3, e2=z3, normal=z3, material_id=zi, geom_index=zi)

        materials = Materials(
            color=jnp.asarray(desc.color, jnp.float32),
            specular_color=jnp.asarray(desc.specular_color, jnp.float32),
            specular_exponent=jnp.asarray(desc.specular_exponent, jnp.float32),
            reflectivity=jnp.asarray(desc.reflectivity, jnp.float32),
            refractive=jnp.asarray(desc.refractive, jnp.float32),
            ior=jnp.asarray(desc.ior, jnp.float32),
            emittance=jnp.asarray(desc.emittance, jnp.float32),
        )
        env = None
        if desc.env_image is not None:
            from ..ops.envmap import build_envmap

            env = build_envmap(desc.env_image, desc.env_strength)
        return cls(
            cubes=batch(CUBE),
            spheres=batch(SPHERE),
            triangles=tris,
            materials=materials,
            camera=derive_camera(desc.camera),
            envmap=env,
        )

    @property
    def num_primitives(self) -> int:
        return self.cubes.count + self.spheres.count + self.triangles.count


def derive_camera(desc: CameraDesc) -> Camera:
    """Build the render camera exactly as the reference's first frame.

    The reference decomposes EYE/LOOKAT into spherical (zoom, phi, theta)
    (`src/main.cpp:64-71`) and rebuilds the basis before the first frame
    (`src/main.cpp:110-128` — `camchanged` starts true), so the *effective*
    camera is the spherical reconstruction, not the raw file values. The
    pixel-length derivation follows `src/scene.cpp:133-140`, including its
    use of tan(fovy) rather than tan(fovy/2).
    """
    zoom, phi, theta = spherical_from_view(desc.eye, desc.lookat)
    position, view, up, right = camera_basis_from_spherical(
        zoom, phi, theta, desc.lookat
    )
    w, h = desc.resolution
    yscaled = np.tan(np.float64(desc.fovy_deg) * np.pi / 180.0)
    xscaled = yscaled * w / h
    pixel_length = np.array([2 * xscaled / w, 2 * yscaled / h], dtype=np.float32)
    return Camera(
        position=jnp.asarray(position, jnp.float32),
        view=jnp.asarray(view, jnp.float32),
        up=jnp.asarray(up, jnp.float32),
        right=jnp.asarray(right, jnp.float32),
        pixel_length=jnp.asarray(pixel_length),
        resolution=(int(w), int(h)),
        aperture=jnp.asarray(float(desc.aperture), jnp.float32),
        # auto-focus: FOCAL ≤ 0 focuses on LOOKAT (zoom is exactly
        # |eye − lookat|, and view points at lookat, so the lookat point
        # lies on the focal plane)
        focal=jnp.asarray(
            float(desc.focal) if desc.focal > 0 else float(zoom), jnp.float32
        ),
    )


def spherical_from_view(eye, lookat):
    """(zoom, phi, theta) such that `camera_basis_from_spherical` reproduces
    the eye exactly.

    Deliberate fix of a reference bug: `src/main.cpp:64-71` decomposes via
    acos of *projected view* components, which mirrors any pitched camera
    (eye.y ≠ lookat.y) about the lookat plane on the first frame — latent in
    the reference because both shipped scenes have a level camera. The
    correct inverse of the reconstruction (`main.cpp:113-115`,
    offset = zoom·(sinφ·sinθ, cosθ, cosφ·sinθ)) is used instead; it is
    identical for level cameras (theta = π/2)."""
    eye = np.asarray(eye, np.float64)
    lookat = np.asarray(lookat, np.float64)
    offset = eye - lookat
    zoom = np.linalg.norm(offset)
    if zoom < 1e-12:
        return 0.0, 0.0, float(np.pi / 2)
    theta = np.arccos(np.clip(offset[1] / zoom, -1.0, 1.0))
    phi = np.arctan2(offset[0], offset[2])
    return float(zoom), float(phi), float(theta)


def camera_basis_from_spherical(zoom, phi, theta, lookat):
    """Rebuild (position, view, up, right) per `src/main.cpp:110-126`."""
    lookat = np.asarray(lookat, np.float64)
    cam_pos = zoom * np.array(
        [np.sin(phi) * np.sin(theta), np.cos(theta), np.cos(phi) * np.sin(theta)]
    )
    view = -cam_pos / np.linalg.norm(cam_pos)
    u = np.array([0.0, 1.0, 0.0])
    right = np.cross(view, u)
    up = np.cross(right, view)
    position = cam_pos + lookat
    return (
        position.astype(np.float32),
        view.astype(np.float32),
        up.astype(np.float32),
        right.astype(np.float32),
    )


def desc_world_aabbs(desc: SceneDesc):
    """Per-geom world AABBs (8-corner method, `src/pathtrace.cu:34-50`),
    extended with exact triangle bounds for mesh scenes."""
    n = desc.num_geoms
    mins = np.zeros((n, 3), np.float32)
    maxs = np.zeros((n, 3), np.float32)
    for i in range(n):
        mins[i], maxs[i] = transforms.unit_cube_world_aabb(desc.transform[i])
    if desc.num_triangles:
        tmins = desc.tri_vertices.min(axis=1)
        tmaxs = desc.tri_vertices.max(axis=1)
        mins = np.concatenate([mins, tmins.astype(np.float32)], axis=0)
        maxs = np.concatenate([maxs, tmaxs.astype(np.float32)], axis=0)
    return mins, maxs
