"""The ("data", "model") mesh across processes (torchrun, one rank a
device): data parallelism, and on the model axis output-channel tensor
parallelism and row partitioning (`parallel.partition`, imported on its
own)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    maybe_initialize_distributed,
    rank,
    world_size,
)
