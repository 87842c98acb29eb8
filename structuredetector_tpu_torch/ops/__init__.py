"""Device ops of the port: decode, targets, losses, normalization, kernels
(JAX `ops/__init__.py`'s names)."""

from .decode import decode_feature_maps, split_head_output
from .encode import EncodedTargets, encode_targets
from .losses import (
    focal_loss,
    masked_l1_loss,
    masked_l2_loss,
    masked_smooth_l1_loss,
    mse_loss,
    sdnet_loss,
)
from .tensor import clamp_in_0_1, clamped_sigmoid, gather_features, plateau_nms, topk_per_class

__all__ = [
    "EncodedTargets", "clamp_in_0_1", "clamped_sigmoid", "decode_feature_maps",
    "encode_targets", "focal_loss", "gather_features", "masked_l1_loss", "masked_l2_loss",
    "masked_smooth_l1_loss", "mse_loss", "plateau_nms", "sdnet_loss", "split_head_output",
    "topk_per_class",
]
