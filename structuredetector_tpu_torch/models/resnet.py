"""ResNet34 encoder pieces, NCHW.

The port of `structuredetector_tpu/models/resnet.py` for the resnet34
backbone the reference ships (`network.py:41-50`): a 7x7/2 stem + BN +
ReLU + 3x3/2 max pool, then BasicBlock stages [3, 4, 6, 3] at widths
[64, 128, 256, 512]. Module names follow torchvision's, so the
reference's `.pth` keys (`adpater.*`, `down{1..4}.*`) load directly
into `models.network.SDNet`.

Training mode follows flax's BatchNorm (`resnet.py:79-81`: momentum 0.9,
eps 1e-5), which writes the biased batch variance into the running
variance, where `torch.nn.BatchNorm2d` writes the unbiased one
(`BatchNorm2d` below).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_SIZES = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (cuDNN's fused kernel, statistics in float32 under
    bf16 autocast) with flax's running variance. Torch's kernel updates a
    copy of the running variance to v = (1 - m) rv + m var * n / (n - 1);
    the buffer then takes (1 - m) rv + m var, the biased batch variance
    over n = B * H * W: rv <- rv (1 - m) / n + v (n - 1) / n. (The kernel
    may keep the variance it was given for its backward pass, so the
    buffer itself is not handed to it.) The module and its state_dict
    keys are torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        v = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, v, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(v, alpha=(n - 1) / n)
        return y


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3-BN-ReLU-3x3-BN + identity, ReLU. The
    1x1 stride-2 downsample has no padding, like flax's "SAME" on even
    sizes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch),
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
        BatchNorm2d(64),
        nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2, padding=1),
    )


def stage(in_ch: int, width: int, n_blocks: int, stride: int) -> nn.Sequential:
    """One resnet stage (`down{1..4}` in the reference)."""
    blocks = [BasicBlock(in_ch, width, stride)]
    blocks += [BasicBlock(width, width) for _ in range(n_blocks - 1)]
    return nn.Sequential(*blocks)
