"""Monte Carlo path tracing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the CUDA
renderer in Sthiber/COSC_4397_Pathtracing_Raytracing_Project (reference
layout: src/pathtrace.cu, src/scene.cpp, src/main.cpp): iterative wavefront
path tracing of transformed unit cubes / spheres (plus triangle meshes as an
extension), BVH acceleration, Russian-roulette termination, an environment sky
light, interactive orbit camera preview, and a performance + PSNR metrics
harness — all expressed as pure functions over pytrees compiled into a single
jitted step per sample batch, scaling over GPU meshes via shard_map.
"""

from .version import __version__

from .scene import (
    Scene,
    SceneDesc,
    load_scene,
    parse_scene,
)
from .render.engine import Renderer, RenderConfig
from .render.state import RenderState

__all__ = [
    "__version__",
    "Scene",
    "SceneDesc",
    "load_scene",
    "parse_scene",
    "Renderer",
    "RenderConfig",
    "RenderState",
]
