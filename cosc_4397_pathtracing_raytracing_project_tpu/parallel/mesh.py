"""Device mesh construction for multi-chip rendering.

The reference is strictly single-GPU (`cudaGLSetGLDevice(0)`,
`src/preview.cpp:112`); scaling here is a 2D ``Mesh(('sp', 'dp'))`` over
the GPUs of a host, where

- ``dp`` shards the *pixel* dimension (each chip owns a contiguous tile of
  the flat pixel array; the scene/BVH pytrees are tiny and fully replicated),
- ``sp`` parallelizes *samples* for the same pixels (partial accumulators
  combined with a ``psum`` — an NCCL all-reduce over NVLink).

No halo exchange is ever needed — paths are independent — so the only
collective in the hot loop is the sample-parallel ``psum``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SAMPLE_AXIS = "sp"
PIXEL_AXIS = "dp"


def make_mesh(
    num_devices: Optional[int] = None,
    sample_parallel: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ('sp', 'dp') mesh over `num_devices` devices with
    `sample_parallel` ranks along the sample axis."""
    if devices is None:
        devices = jax.devices()
    if num_devices is None:
        num_devices = len(devices)
    if num_devices % sample_parallel != 0:
        raise ValueError(
            f"num_devices={num_devices} not divisible by sp={sample_parallel}"
        )
    grid = np.array(devices[:num_devices]).reshape(
        sample_parallel, num_devices // sample_parallel
    )
    return Mesh(grid, (SAMPLE_AXIS, PIXEL_AXIS))


def pixel_sharding(mesh: Mesh) -> NamedSharding:
    """Accumulator sharding: pixels split over dp, replicated over sp."""
    return NamedSharding(mesh, P(PIXEL_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
