"""Swin Transformer V2 encoder for SDNet (Liu et al., "Swin Transformer V2:
Scaling Up Capacity and Resolution", CVPR 2022, arXiv:2111.09883), in
torchvision's `swin_v2_b` module layout, so a torchvision checkpoint
warm-starts it (`models.weights.load_imagenet_encoder`).

Channels-last (B, H, W, C) inside, as torchvision runs it:

- `features.0`: the patch embedding, Conv2d(in, C, 4, stride 4), to NHWC,
  LayerNorm;
- `features.{1,3,5,7}`: the stages' blocks, post-norm:
  x = x + LN1(attn(x)), x = x + LN2(MLP(x)), MLP = Linear(C, 4C), exact
  GELU, Linear(4C, C);
- `features.{2,4,6}`: patch merging V2, the 2x2 neighbours concatenated
  (torchvision's order), Linear(4C, 2C, bias=False), LayerNorm(2C);
- `norms.{0..3}`: a LayerNorm on each stage's output (C2..C5), as the
  Swin detection backbones put one there; the outputs leave NCHW.

Attention in one window of 8x8 tokens is scaled cosine attention:
normalize(q) . normalize(k)^T times exp(min(logit_scale, ln 100)), plus
16 sigmoid of the continuous position bias (`cpb_mlp` over the log-spaced
table, gathered by relative index), plus -100 between tokens of different
regions of a shifted window; softmax; times v. The qkv bias's k third
is held at zero, as torchvision does. Odd blocks shift by half a window,
except along a dimension whose padded size is the window.

The port's order differs from torchvision's where the arithmetic allows:
qkv runs on the (B, H, W, C) map before padding and partition, the
padded tokens then taking the qkv bias (torchvision's Linear of zeros),
and proj runs after the windows are put back and cropped. So the span
`sd.swin.attn` holds the attention core alone: the position bias, then
padding, shift, partition, the attention, reverse and crop in one call
of `ops.kernels.window_attention`: on the card one launch of a
hand-written kernel that reads q, k and v from the qkv Linear's output
and writes each token's output in place, with the shift mask recomputed
from each window's position; on the CPU its plain PyTorch version.

Stochastic depth is not implemented (rate 0): the encoder trains as
torchvision's with `stochastic_depth_prob=0`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.swin_window_attention import window_attention
from ..tracing import SWIN, span


class SwinSpec(NamedTuple):
    embed: int
    depths: Tuple[int, ...]
    heads: Tuple[int, ...]
    window: int = 8
    mlp_ratio: int = 4
    patch: int = 4


# torchvision `swin_v2_b`: 87,930,848 parameters with its classifier
ARCHS = {"swin_v2_b": SwinSpec(128, (2, 2, 18, 2), (4, 8, 16, 32))}


class Permute(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(self.dims)


def relative_coords_table(window: int) -> torch.Tensor:
    """(2w-1, 2w-1, 2) log-spaced relative coordinates: each offset over
    (w - 1), times 8, then sign * log2(|x| + 1) / 3."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    table = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1) / (window - 1) * 8
    return torch.sign(table) * torch.log2(table.abs() + 1.0) / 3.0


def relative_position_index(window: int) -> torch.Tensor:
    """(w*w * w*w,) index of each (query, key) pair's offset into the table."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).flatten()


class ShiftedWindowAttentionV2(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, odd: bool):
        super().__init__()
        self.dim, self.heads, self.window, self.odd = dim, heads, window, odd
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones((heads, 1, 1))))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(inplace=True),
                                     nn.Linear(512, heads, bias=False))
        with torch.no_grad():
            self.qkv.bias[dim:2 * dim].zero_()
        self.register_buffer("relative_coords_table", relative_coords_table(window),
                             persistent=False)
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)

    def qkv_bias(self) -> torch.Tensor:
        b = self.qkv.bias
        return torch.cat([b[:self.dim], torch.zeros_like(b[:self.dim]), b[2 * self.dim:]])

    def position_bias(self) -> torch.Tensor:
        """(heads, N, N): 16 sigmoid of the cpb MLP's table, by relative index."""
        n = self.window * self.window
        table = self.cpb_mlp(self.relative_coords_table).view(-1, self.heads)
        # indexing (not index_select): its backward is deterministic on the card
        bias = table.t()[:, self.relative_position_index]
        return 16 * torch.sigmoid(bias.view(self.heads, n, n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        bias = self.qkv_bias()
        qkv = F.linear(x, self.qkv.weight, bias)
        with span("sd.swin.attn"):
            y = self.core(qkv, bias)
        return self.proj(y)

    def core(self, qkv: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3C) -> (B, H, W, C): pad, shift, partition, attend,
        reverse, crop."""
        return window_attention(qkv, bias, self.position_bias(), self.logit_scale, self.odd)


class SwinBlockV2(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, odd: bool, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftedWindowAttentionV2(dim, heads, window, odd)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        # torchvision's MLP: its dropouts (rate 0) hold indices 2 and 4
        self.mlp = nn.Sequential(nn.Linear(dim, mlp_ratio * dim), nn.GELU(), nn.Identity(),
                                 nn.Linear(mlp_ratio * dim, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.norm1(self.attn(x))
        with span("sd.swin.mlp"):
            return x + self.norm2(self.mlp(x))


class PatchMergingV2(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("sd.swin.merge"):
            h, w = x.shape[1:3]
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], dim=-1)
            return self.norm(self.reduction(x))


class SwinV2Encoder(nn.Module):
    """(B, in_channels, H, W) -> (C2, C3, C4, C5) NCHW at strides 4, 8, 16
    and 32, widths `widths` (C, 2C, 4C, 8C)."""

    def __init__(self, in_channels: int = 3, spec: SwinSpec = ARCHS["swin_v2_b"]):
        super().__init__()
        self.spec = spec
        c = spec.embed
        layers = [nn.Sequential(nn.Conv2d(in_channels, c, spec.patch, stride=spec.patch),
                                Permute([0, 2, 3, 1]), nn.LayerNorm(c, eps=1e-5))]
        for i, (depth, heads) in enumerate(zip(spec.depths, spec.heads)):
            dim = c * 2 ** i
            layers.append(nn.ModuleList(SwinBlockV2(dim, heads, spec.window, j % 2 == 1,
                                                    spec.mlp_ratio) for j in range(depth)))
            if i < len(spec.depths) - 1:
                layers.append(PatchMergingV2(dim))
        self.features = nn.Sequential(*layers)
        self.widths = tuple(c * 2 ** i for i in range(len(spec.depths)))
        self.norms = nn.ModuleList(nn.LayerNorm(d, eps=1e-5) for d in self.widths)

    def forward(self, x: torch.Tensor):
        SWIN.forwards += 1
        with span("sd.swin.embed"):
            x = self.features[0](x)
        outs = []
        for i, norm in enumerate(self.norms):
            if i > 0:
                x = self.features[2 * i](x)
            for block in self.features[2 * i + 1]:
                x = block(x)
            outs.append(norm(x).permute(0, 3, 1, 2))
        return tuple(outs)
