"""ResNet34 encoder pieces, NCHW.

The port of `structuredetector_tpu/models/resnet.py` for the resnet34
backbone the reference ships (`network.py:41-50`): a 7x7/2 stem + BN +
ReLU + 3x3/2 max pool, then BasicBlock stages [3, 4, 6, 3] at widths
[64, 128, 256, 512]. Module names follow torchvision's, so the
reference's `.pth` keys (`adpater.*`, `down{1..4}.*`) load directly
into `models.network.SDNet`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_SIZES = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3-BN-ReLU-3x3-BN + identity, ReLU. The
    1x1 stride-2 downsample has no padding, like flax's "SAME" on even
    sizes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + identity)


def stem(in_channels: int) -> nn.Sequential:
    """The reference's `adpater`: conv1, bn1, relu, maxpool of resnet34."""
    return nn.Sequential(
        nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False),
        nn.BatchNorm2d(64),
        nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2, padding=1),
    )


def stage(in_ch: int, width: int, n_blocks: int, stride: int) -> nn.Sequential:
    """One resnet stage (`down{1..4}` in the reference)."""
    blocks = [BasicBlock(in_ch, width, stride)]
    blocks += [BasicBlock(width, width) for _ in range(n_blocks - 1)]
    return nn.Sequential(*blocks)
