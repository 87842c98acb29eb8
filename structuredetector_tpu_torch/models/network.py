"""SDNet: ResNet34 encoder + FPN decoder + 1x1 head, NCHW.

The port of `structuredetector_tpu/models/network.py`; the structure and
the module names are the reference `Network`'s
(`/root/reference/src/sdnet/model/network.py:32-87`):

- `adpater` + `down1..down4`: the resnet34 encoder (stages C2..C5),
- `up1`: 1x1 conv 512 -> fpn_depth on C5,
- `up2..up4`: FPN blocks: nearest x2 upsample + 1x1 lateral conv on the
  skip + sum + 3x3 conv(bias=False) + BN + ReLU,
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
output in the compute dtype; the stem and the head stay float. Int8 is
inference-only: a train-mode forward raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from ..ops.decode import split_head_output
from .quantize import swap_int8_convs
from .resnet import STAGE_SIZES, STAGE_WIDTHS, BatchNorm2d, stage, stem


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

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x_nearest(x) + self.lateral(skip))


class Head(nn.Module):
    """The reference's single shared 1x1 head (network.py:22-29)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


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


class SDNet(nn.Module):
    """Anchor+parts structure detection network, output stride 4."""

    def __init__(self, n_labels: int, n_parts: int, fpn_depth: int = 128,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 int8: bool = False):
        super().__init__()
        self.n_labels = n_labels
        self.n_parts = n_parts
        self.dtype = dtype
        self.int8 = int8
        self.adpater = stem(in_channels)
        in_ch = 64
        for i, (n_blocks, width) in enumerate(zip(STAGE_SIZES, STAGE_WIDTHS), start=1):
            setattr(self, f"down{i}", stage(in_ch, width, n_blocks, 1 if i == 1 else 2))
            in_ch = width
        self.up1 = nn.Conv2d(STAGE_WIDTHS[3], fpn_depth, 1)
        self.up2 = FpnBlock(STAGE_WIDTHS[2], fpn_depth)
        self.up3 = FpnBlock(STAGE_WIDTHS[1], fpn_depth)
        self.up4 = FpnBlock(STAGE_WIDTHS[0], fpn_depth)
        self.head = Head(fpn_depth, n_labels + n_parts + 4)
        if int8:
            swap_int8_convs(self, dtype)

    @property
    def out_channels(self) -> int:
        return self.n_labels + self.n_parts + 4

    def forward(self, x: torch.Tensor, raw_output: bool = False):
        """x: (B, in_channels, H, W) normalized float32. Returns the
        (B, M+N+4, H/4, W/4) float32 head output with `raw_output`, else
        its split into 'anchor_hm', 'part_hm', 'offsets', 'embeddings'."""
        if self.int8 and self.training:
            raise ValueError("int8 is an inference-only mode; train in float")
        with _precision(self.dtype, x.device):
            c2 = self.down1(self.adpater(x))
            c3 = self.down2(c2)
            c4 = self.down3(c3)
            c5 = self.down4(c4)
            f = self.up4(self.up3(self.up2(self.up1(c5), c4), c3), c2)
            out = self.head(f).float()
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
