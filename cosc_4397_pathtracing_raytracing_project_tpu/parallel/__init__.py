from .mesh import PIXEL_AXIS, SAMPLE_AXIS, make_mesh, pixel_sharding, replicated
from .shard import (
    make_sharded_mesh_step,
    make_sharded_step,
    render_chunk_sharded,
    render_chunk_sharded_mesh,
    render_tiles_sharded,
)

__all__ = [
    "PIXEL_AXIS",
    "SAMPLE_AXIS",
    "make_mesh",
    "pixel_sharding",
    "replicated",
    "make_sharded_mesh_step",
    "render_chunk_sharded_mesh",
    "make_sharded_step",
    "render_chunk_sharded",
    "render_tiles_sharded",
]
