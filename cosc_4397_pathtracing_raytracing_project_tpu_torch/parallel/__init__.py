"""Multi-device rendering over a ``('sp', 'dp')`` device mesh of rank
processes (``torch.distributed``); the port of the JAX package's
``parallel``."""

from .mesh import (
    PIXEL_AXIS,
    SAMPLE_AXIS,
    gather_pixels,
    make_mesh,
    pixel_sharding,
    replicated,
    spawn_ranks,
    start_rank,
)
from .shard import (
    make_sharded_mesh_step,
    make_sharded_pallas_step,
    make_sharded_step,
    render_chunk_sharded,
    render_chunk_sharded_mesh,
    render_chunk_sharded_pallas,
    render_tiles_sharded,
)

__all__ = [
    "PIXEL_AXIS",
    "SAMPLE_AXIS",
    "make_mesh",
    "pixel_sharding",
    "replicated",
    "make_sharded_pallas_step",
    "make_sharded_mesh_step",
    "render_chunk_sharded_mesh",
    "make_sharded_step",
    "render_chunk_sharded_pallas",
    "render_chunk_sharded",
    "render_tiles_sharded",
    "gather_pixels",
    "start_rank",
    "spawn_ranks",
]
