"""Hand-written CUDA kernels of the decode front, each with its plain
PyTorch version beside it."""

from typing import Dict

from .nms import sigmoid_nms, sigmoid_nms_reference
from .topk import sigmoid_nms_topk, sigmoid_nms_topk_reference

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "sigmoid_nms",
    "sigmoid_nms_reference",
    "sigmoid_nms_topk",
    "sigmoid_nms_topk_reference",
]


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel (named after its
    source in csrc/)."""
    by_variant = sigmoid_nms_topk.launches_by_variant
    return {
        "sigmoid_nms": sigmoid_nms.launches,
        "sigmoid_nms_topk": by_variant["rounds"],
        "sigmoid_nms_topk_rowmax": by_variant["onehot"],
    }


def reset_launch_counts() -> None:
    sigmoid_nms.launches = 0
    for variant in sigmoid_nms_topk.launches_by_variant:
        sigmoid_nms_topk.launches_by_variant[variant] = 0
