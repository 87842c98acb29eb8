"""Hand-written CUDA kernels of the decode front, each with its plain
PyTorch version beside it."""

from .nms import sigmoid_nms, sigmoid_nms_reference
from .topk import sigmoid_nms_topk, sigmoid_nms_topk_reference

__all__ = [
    "sigmoid_nms",
    "sigmoid_nms_reference",
    "sigmoid_nms_topk",
    "sigmoid_nms_topk_reference",
]
