"""The port's SDNet and its weights (JAX `models/__init__.py`'s names:
`load_params`/`save_params` are `load_checkpoint`/`save_msgpack` here,
`ResNet34Encoder` is `ResNetEncoder`)."""

from .network import ResNetEncoder, SDNet, build_model, init_model
from .weights import (
    export_reference_state_dict,
    load_checkpoint,
    load_weights,
    save_msgpack,
    save_reference_pth,
)

__all__ = [
    "ResNetEncoder", "SDNet", "build_model", "export_reference_state_dict", "init_model",
    "load_checkpoint", "load_weights", "save_msgpack", "save_reference_pth",
]
