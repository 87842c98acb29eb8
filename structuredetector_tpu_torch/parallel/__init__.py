"""Data parallelism across processes (torchrun, one rank a device)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    maybe_initialize_distributed,
    rank,
    world_size,
)
