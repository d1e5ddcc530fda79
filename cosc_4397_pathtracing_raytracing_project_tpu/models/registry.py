"""Renderer model registry.

Each entry corresponds to one of the reference project's benchmark
configurations (`README.md:30-59`, BASELINE.md), re-designed for XLA:

- ``naive``       — brute-force all-primitive intersection, readable XLA
                    pipeline (reference "Naive" row).
- ``shared``      — SoA fast path; the analog of the reference's
                    "shared memory + coalesced" optimizations (material/
                    scene constants folded into the fused kernels,
                    unit-stride per-component access).
- ``bvh``         — BVH-accelerated intersection with stackless threaded
                    traversal (reference "BVH" row).
- ``wavefront``   — explicit pixel-index wavefront with optional stream
                    compaction / material sorting (the reference's attempted
                    experiments, done correctly).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax

from ..render.engine import RenderConfig, Renderer


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    description: str
    config_overrides: dict


_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def available_models():
    return sorted(_REGISTRY)


def get(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {', '.join(available_models())}"
        )
    return _REGISTRY[name]


register(
    ModelSpec(
        "naive",
        "brute-force intersection, readable XLA pipeline",
        {"pipeline": "reference", "intersector": "bruteforce"},
    )
)
register(
    ModelSpec(
        "shared",
        "SoA fast path (analog of shared-mem + coalesced)",
        {"pipeline": "fast"},
    )
)
register(
    ModelSpec(
        "bvh",
        "BVH-accelerated intersection (stackless threaded traversal)",
        {"pipeline": "reference", "intersector": "bvh"},
    )
)
register(
    ModelSpec(
        "wavefront",
        "pixel-indexed wavefront with compaction / material sort",
        {"pipeline": "wavefront"},
    )
)


def make_renderer(
    model: str,
    scene,
    config: Optional[RenderConfig] = None,
    seed: int = 0,
    compaction: str = "none",
) -> Renderer:
    """Construct a Renderer configured as the named model."""
    spec = get(model)
    base = config or RenderConfig()
    overrides = dict(spec.config_overrides)
    if model == "wavefront":
        # the wavefront pipeline is driven through a custom step function
        if base.nee:
            # its step bypasses trace_sample, so nee would silently no-op
            raise ValueError(
                "nee is not supported by the wavefront-compaction model — "
                "use 'auto', 'shared', 'naive' or 'bvh'"
            )
        overrides = {"pipeline": "reference"}
    cfg = dataclasses.replace(base, **overrides)
    renderer = Renderer(scene, cfg, seed=seed)
    if model == "wavefront":
        from .wavefront import render_chunk_wavefront

        isect = renderer._intersector

        def _chunk(scene, state, config, num_samples):
            return render_chunk_wavefront(
                scene, state, config, num_samples, compaction, isect
            )

        renderer._step = jax.jit(
            _chunk, static_argnames=("config", "num_samples")
        )
    return renderer
