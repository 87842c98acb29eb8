"""ResNet encoder pieces, NCHW.

The port of `structuredetector_tpu/models/resnet.py`: a 7x7/2 stem +
BN + ReLU + 3x3/2 max pool, then four stages at base widths [64, 128,
256, 512] of torchvision's BasicBlock (resnet18 [2, 2, 2, 2], resnet34
[3, 4, 6, 3], the reference's backbone, `network.py:41-50`) or
Bottleneck (resnet50 [3, 4, 6, 3], expansion 4): `ARCHS`. Module names
follow torchvision's, so the reference's `.pth` keys (`adpater.*`,
`down{1..4}.*`) load directly into `models.network.SDNet`.

The space-to-depth stem (`S2dStemConv`, JAX `resnet.py:30-61`) is the
same function as the 7x7/2 conv: a 4x4/1 conv on the 12 channels of
`space_to_depth(x)`, padded ((2, 1), (2, 1)); `stem_kernel_to_s2d`
rewrites a 7x7 kernel into it exactly.

Training mode follows flax's BatchNorm (`resnet.py:79-81`: momentum 0.9,
eps 1e-5), which writes the biased batch variance into the running
variance, where `torch.nn.BatchNorm2d` writes the unbiased one
(`BatchNorm2d` below). Every BN of every block kind is one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import world_size

STAGE_WIDTHS = (64, 128, 256, 512)  # base widths; a Bottleneck stage puts out 4x


def _channel_sums(t: torch.Tensor) -> torch.Tensor:
    return t.sum(dim=(0, 2, 3))


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the batches of every rank of `group` (None:
    the default process group), in float32. Forward: the channel sums,
    then the centred sums of squares, each all-reduced (two passes, so the
    variance keeps its digits where the mean is large); the batch variance
    is the biased one over the group's count n (every rank holds a batch
    of the same shape, `parallel.multihost`). Backward: the rank's dx of
    the global loss from the all-reduced sums of dy and dy * x_hat; the
    weight and bias gradients stay the rank's own, which the parallel step
    reduces with the other parameters'."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        n = x.numel() // x.shape[1] * dist.get_world_size(group)
        sums = _channel_sums(xf)
        dist.all_reduce(sums, group=group)
        mean = sums / n
        centred = xf - _per_channel(mean)
        sq = _channel_sums(centred * centred)
        dist.all_reduce(sq, group=group)
        var = sq / n
        invstd = torch.rsqrt(var + eps)
        y = centred * _per_channel(invstd * weight) + _per_channel(bias)
        ctx.n, ctx.group = n, group
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        n = ctx.n
        dyf = dy.float()
        x_hat = (x.float() - _per_channel(mean)) * _per_channel(invstd)
        c = x.shape[1]
        local = torch.cat((_channel_sums(dyf), _channel_sums(dyf * x_hat)))
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (dyf - _per_channel(sums[:c] / n) - x_hat * _per_channel(sums[c:] / n)) \
            * _per_channel(invstd * weight)
        return dx.to(x.dtype), local[c:], local[:c], None, None


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (cuDNN's fused kernel, statistics in float32 under
    bf16 autocast) with flax's running variance. Torch's kernel updates a
    copy of the running variance to v = (1 - m) rv + m var * n / (n - 1);
    the buffer then takes (1 - m) rv + m var, the biased batch variance
    over n = B * H * W: rv <- rv (1 - m) / n + v (n - 1) / n. (The kernel
    may keep the variance it was given for its backward pass, so the
    buffer itself is not handed to it.) The module and its state_dict
    keys are torch's.

    In train mode under a process group of more than one rank
    (`parallel.mesh`), the statistics are those of the batch that the
    ranks of `group` hold together (None: every rank of the default
    group; the data group under the model axis, whose ranks own distinct
    channels), as under the JAX package's sharded `jit`: the forward and
    the backward all-reduce them (`_GlobalBatchNorm`), and the running
    statistics take the global mean and the biased variance over n =
    ranks * B * H * W, the same on every rank."""

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        if world_size() > 1 and dist.get_world_size(group) > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, group)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            return y
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
    sizes. The blocks hold the modules; `models.network.SDNet.forward`
    runs them (`network._block`)."""

    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.downsample = _downsample(in_ch, width, stride)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (v1.5: the stride on the 3x3): 1x1 reduce,
    3x3, 1x1 expand to 4 * width, BN after each, identity add, ReLU (JAX
    `resnet.py:112-150`)."""

    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample = _downsample(in_ch, out_ch, stride)


def _downsample(in_ch: int, out_ch: int, stride: int):
    """The 1x1 projection of the identity where the block changes the
    stride or the width (resnet50's first stage too: 64 -> 256)."""
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                         BatchNorm2d(out_ch))


# backbone name -> (block module, blocks per stage), JAX `resnet.py:155-160`
ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def stage_channels(backbone: str) -> tuple:
    """Output channels of the four stages (C2..C5) of `backbone`."""
    block, _ = ARCHS[backbone]
    return tuple(w * block.expansion for w in STAGE_WIDTHS)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2); channel (ry*2 + rx)*C + c holds
    pixel (2i + ry, 2j + rx) of channel c, JAX `space_to_depth`'s order."""
    _, c, h, w = x.shape
    x = x.reshape(-1, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(-1, 4 * c, h // 2, w // 2)


def stem_kernel_to_s2d(k7: np.ndarray) -> np.ndarray:
    """Rewrite a 7x7/stride-2 stem kernel (7, 7, Cin, Cout), HWIO, as the
    equivalent 4x4/stride-1 kernel (4, 4, 4*Cin, Cout) over
    `space_to_depth` input (the port's copy of JAX `stem_kernel_to_s2d`).

    The 7x7 kernel (taps at -3..3 around the output centre) is zero-padded
    to 8x8 (-4..3) and split by tap parity: tap t = 2u + r lands at s2d
    position u, phase r. With input padding ((2, 1), (2, 1)) the receptive
    field and the zero padding are the 7x7 conv's; outputs differ only by
    summation order."""
    k7 = np.asarray(k7)
    kh, kw, cin, cout = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {k7.shape}")
    kpad = np.zeros((8, 8, cin, cout), k7.dtype)
    kpad[1:, 1:] = k7
    out = np.zeros((4, 4, 4 * cin, cout), k7.dtype)
    for ry in (0, 1):
        for rx in (0, 1):
            g = (ry * 2 + rx) * cin
            out[:, :, g: g + cin, :] = kpad[ry::2, rx::2, :, :]
    return out


class S2dStemConv(nn.Conv2d):
    """The space-to-depth stem conv: `space_to_depth`, zero padding
    ((2, 1), (2, 1)) (`Conv2d` pads only symmetrically), then a 4x4/1 conv
    from 4 * in_channels to 64. Its weight is the `adpater.0.weight` of
    the state_dict, (64, 4 * in_channels, 4, 4)."""

    def __init__(self, in_channels: int, out_channels: int = 64):
        super().__init__(4 * in_channels, out_channels, 4, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(space_to_depth(x), (2, 1, 2, 1)))


def stem(in_channels: int, s2d: bool = False) -> nn.Sequential:
    """The reference's `adpater`: conv1, bn1, relu, maxpool; conv1 the
    7x7/2 conv or, with `s2d`, `S2dStemConv`."""
    conv = (S2dStemConv(in_channels) if s2d
            else nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False))
    return nn.Sequential(conv, BatchNorm2d(64), nn.ReLU(inplace=True),
                         nn.MaxPool2d(3, stride=2, padding=1))


def stage(block, in_ch: int, width: int, n_blocks: int, stride: int) -> nn.Sequential:
    """One resnet stage (`down{1..4}` in the reference) of `block`s."""
    out_ch = width * block.expansion
    blocks = [block(in_ch, width, stride)]
    blocks += [block(out_ch, width) for _ in range(n_blocks - 1)]
    return nn.Sequential(*blocks)
