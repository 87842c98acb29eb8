"""SDNet: ResNet encoder + FPN decoder + head, NCHW.

The port of `structuredetector_tpu/models/network.py`; the structure and
the module names are the reference `Network`'s
(`/root/reference/src/sdnet/model/network.py:32-87`):

- `adpater` + `down1..down4`: the encoder (stages C2..C5), resnet34 as
  in the reference, or resnet18 / resnet50 (`backbone`), with the 7x7
  or the space-to-depth stem (`s2d_stem`),
- `up1`: 1x1 conv C5 -> fpn_depth (512 channels, 2048 for resnet50),
- `up2..up4`: FPN blocks: nearest x2 upsample + 1x1 lateral conv on the
  skip + sum + 3x3 conv(bias=False) + BN + ReLU,
- `head_hidden` (only with `head_conv` > 0): a 3x3 conv with bias and a
  ReLU, the CenterNet head of JAX `network.py:176-180`,
- `head.conv`: 1x1 conv to M+N+4 channels at output stride 4.

The head output (B, M+N+4, H/4, W/4) is already in the (B * C, H, W)
plane order the decode kernels read, so the JAX package's channel-
leading head has no counterpart here.

Precision: with `dtype=torch.bfloat16` the forward runs under autocast
(bf16 convolutions, f32 parameters and BN statistics); with float32 it
runs with TF32 off, so fp32 means fp32. The head output is float32
either way. In train mode the BatchNorm layers follow flax's running
variance (`resnet.BatchNorm2d`).

With `int8`, every residual-block and FPN conv is an `Int8Conv2d`
(`models.quantize`): int8 activations and weights, int32 sums, the
output in the compute dtype; the stem (either form) and the head
(`head_hidden` too) stay float. Int8 is
inference-only: a train-mode forward raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.decode import split_head_output
from .quantize import swap_int8_convs
from .resnet import ARCHS, STAGE_WIDTHS, BatchNorm2d, Bottleneck, stage, stage_channels, stem


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of (B, C, H, W) as a broadcast copy (JAX
    `network.py:35-40`): the values of `F.interpolate(x, scale_factor=2)`,
    and the dtype of `x` under autocast too. CUDA autocast runs
    `upsample_nearest2d` in float32, while a `torch.export` trace on the
    card records it in bf16, so an exported int8 program's dtype check on
    the FPN sum failed at run time."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


class FpnBlock(nn.Module):
    """Upsample x2 + lateral 1x1 + add + 3x3 conv(bias=False)+BN+ReLU
    (reference Fpn, network.py:6-19)."""

    def __init__(self, skip_channels: int, filters: int):
        super().__init__()
        self.lateral = nn.Conv2d(skip_channels, filters, 1)
        self.conv = nn.Sequential(
            nn.Conv2d(filters, filters, 3, padding=1, bias=False),
            BatchNorm2d(filters),
            nn.ReLU(inplace=True),
        )


class Head(nn.Module):
    """The reference's single shared 1x1 head (network.py:22-29)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)


def no_tf32(dtype: torch.dtype, device: torch.device):
    """With float32 compute on the card, cuDNN's TF32 off for the
    convolutions run inside (so fp32 means fp32). The train step also
    holds it around the backward pass, whose convolutions run after the
    forward's context has closed."""
    if dtype == torch.float32 and device.type == "cuda":
        cudnn = torch.backends.cudnn
        return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                           deterministic=cudnn.deterministic, allow_tf32=False)
    return contextlib.nullcontext()


def _precision(dtype: torch.dtype, device: torch.device):
    if dtype == torch.bfloat16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    if dtype != torch.float32:
        raise ValueError(f"compute dtype must be bfloat16 or float32, not {dtype}")
    return no_tf32(dtype, device)


class PlainPlan:
    """How `SDNet.forward`'s walk runs each op in one process: the module
    itself on the whole tensor. The plans of `parallel.partition` place
    the same ops over the mesh's model axis."""

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def leave(self, a: torch.Tensor) -> torch.Tensor:
        return a

    def conv(self, m: nn.Module, a: torch.Tensor) -> torch.Tensor:
        return m(a)

    bn = maxpool = conv

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b

    def relu(self, a: torch.Tensor) -> torch.Tensor:
        return F.relu(a)

    def upsample(self, a: torch.Tensor) -> torch.Tensor:
        return upsample2x_nearest(a)


PLAIN = PlainPlan()


def _block(plan, block: nn.Module, a):
    """A `resnet.BasicBlock` or `resnet.Bottleneck` under `plan`:
    conv-BN-ReLU (twice for the bottleneck), conv-BN, plus the identity
    (its 1x1 projection where the block has one), ReLU."""
    identity = a
    if block.downsample is not None:
        conv, bn = block.downsample
        identity = plan.bn(bn, plan.conv(conv, a))
    y = plan.relu(plan.bn(block.bn1, plan.conv(block.conv1, a)))
    if isinstance(block, Bottleneck):
        y = plan.relu(plan.bn(block.bn2, plan.conv(block.conv2, y)))
        y = plan.bn(block.bn3, plan.conv(block.conv3, y))
    else:
        y = plan.bn(block.bn2, plan.conv(block.conv2, y))
    return plan.relu(plan.add(y, identity))


class SDNet(nn.Module):
    """Anchor+parts structure detection network, output stride 4."""

    def __init__(self, n_labels: int, n_parts: int, fpn_depth: int = 128,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 int8: bool = False, backbone: str = "resnet34", s2d_stem: bool = False,
                 head_conv: int = 0):
        super().__init__()
        self.n_labels = n_labels
        self.n_parts = n_parts
        self.dtype = dtype
        self.int8 = int8
        self.backbone = backbone
        self.adpater = stem(in_channels, s2d=s2d_stem)
        block, stage_sizes = ARCHS[backbone]
        in_ch = 64
        for i, (n_blocks, width) in enumerate(zip(stage_sizes, STAGE_WIDTHS), start=1):
            setattr(self, f"down{i}", stage(block, in_ch, width, n_blocks, 1 if i == 1 else 2))
            in_ch = width * block.expansion
        # the FPN reads C2..C5 at the block's widths (resnet50: 256..2048)
        c2, c3, c4, c5 = stage_channels(backbone)
        self.up1 = nn.Conv2d(c5, fpn_depth, 1)
        self.up2 = FpnBlock(c4, fpn_depth)
        self.up3 = FpnBlock(c3, fpn_depth)
        self.up4 = FpnBlock(c2, fpn_depth)
        self.head_hidden = (nn.Conv2d(fpn_depth, head_conv, 3, padding=1) if head_conv > 0
                            else None)
        self.head = Head(head_conv or fpn_depth, n_labels + n_parts + 4)
        if int8:
            swap_int8_convs(self, dtype)

    @property
    def out_channels(self) -> int:
        return self.n_labels + self.n_parts + 4

    def forward(self, x: torch.Tensor, raw_output: bool = False, partition=None):
        """x: (B, in_channels, H, W) normalized float32. Returns the
        (B, M+N+4, H/4, W/4) float32 head output with `raw_output`, else
        its split into 'anchor_hm', 'part_hm', 'offsets', 'embeddings'.

        One walk of the modules, each op placed by `partition`: None (one
        process, `PlainPlan`), or a plan of the mesh's model axis
        (`parallel.partition`), under which x is this rank's whole input
        and every rank of its model group returns the whole output."""
        if self.int8 and self.training:
            raise ValueError("int8 is an inference-only mode; train in float")
        if self.int8 and partition is not None:
            raise ValueError("an int8 model is not partitioned over the model axis")
        plan = PLAIN if partition is None else partition
        with _precision(self.dtype, x.device):
            conv, bn, _, pool = self.adpater
            a = plan.maxpool(pool, plan.relu(plan.bn(bn, plan.conv(conv, plan.enter(x)))))
            stages = []
            for i in range(1, 5):
                for block in getattr(self, f"down{i}"):
                    a = _block(plan, block, a)
                stages.append(a)
            c2, c3, c4, c5 = stages
            f = plan.conv(self.up1, c5)
            for up, skip in ((self.up2, c4), (self.up3, c3), (self.up4, c2)):
                f = plan.add(plan.upsample(f), plan.conv(up.lateral, skip))
                conv, bn, _ = up.conv
                f = plan.relu(plan.bn(bn, plan.conv(conv, f)))
            if self.head_hidden is not None:
                f = plan.relu(plan.conv(self.head_hidden, f))
            out = plan.leave(plan.conv(self.head.conv, f)).float()
        if raw_output:
            return out
        return split_head_output(out, self.n_labels, self.n_parts)


def build_model(config, dtype: Optional[torch.dtype] = None) -> SDNet:
    return SDNet(
        n_labels=config.n_labels,
        n_parts=config.n_parts,
        fpn_depth=config.fpn_depth,
        in_channels=config.in_channels,
        dtype=dtype if dtype is not None else config.compute_dtype,
        int8=config.int8,
        backbone=config.backbone,
        s2d_stem=config.s2d_stem,
        head_conv=config.head_conv,
    )


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initialization as the JAX package's flax modules draw it:
    LeCun-normal convolutions (variance 1 / fan_in, truncated at two
    standard deviations), zero biases, unit BN scales. An untrained
    model in eval mode then keeps its maps O(1), so its detections land
    inside the image (torchvision's fan-out He init grows them to ~1e3
    over 40 layers without batch statistics)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # flax's truncated_normal: std corrected for the cut at +-2
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def init_model(config) -> SDNet:
    """A `build_model` SDNet with weights seeded by `config.seed`, in eval
    mode on the CPU."""
    model = build_model(config)
    init_weights(model, config.seed)
    return model.eval()
